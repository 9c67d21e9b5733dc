// surfkit: native host-side runtime for surface_sampling_tpu_torch.
//
// The host hot spots that sit outside the device programs: O(N)
// linked-cell neighbour enumeration for large slabs (capacity estimation,
// site finding, overflow checks), periodic minimum-image distance filters
// over sampled trajectories, and fast multi-frame XYZ writing. Pure C ABI,
// bound with ctypes (runtime/native.py, which also keeps numpy versions of
// all three). A copy of surface_sampling_tpu/runtime/csrc/surfkit.cpp.
//
// Build: g++ -O3 -fPIC -shared at first use, into the package's _build/ (no
// -march=native: a library built on one host must load on another).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Solve frac = cart @ inv(cell) for a 3x3 row-vector cell.
static void invert3(const double *c, double *inv) {
  double a = c[0], b = c[1], cc = c[2];
  double d = c[3], e = c[4], f = c[5];
  double g = c[6], h = c[7], i = c[8];
  double det = a * (e * i - f * h) - b * (d * i - f * g) + cc * (d * h - e * g);
  double id = 1.0 / det;
  inv[0] = (e * i - f * h) * id;
  inv[1] = (cc * h - b * i) * id;
  inv[2] = (b * f - cc * e) * id;
  inv[3] = (f * g - d * i) * id;
  inv[4] = (a * i - cc * g) * id;
  inv[5] = (cc * d - a * f) * id;
  inv[6] = (d * h - e * g) * id;
  inv[7] = (b * g - a * h) * id;
  inv[8] = (a * e - b * d) * id;
}

// Linked-cell neighbor enumeration under periodic boundary conditions.
//
// positions: (n, 3) cartesian; cell: (3, 3) rows; pbc: 3 ints.
// Writes up to max_neighbors entries per atom into nbr_idx (n, max_neighbors)
// and nbr_disp (n, max_neighbors, 3); counts into nbr_count (n).
// Returns the maximum neighbor count encountered (may exceed max_neighbors —
// caller uses it to size padded device arrays).
int64_t sk_cell_list_neighbors(const double *positions, int64_t n,
                               const double *cell, const int32_t *pbc,
                               double cutoff, int64_t max_neighbors,
                               int32_t *nbr_idx, double *nbr_disp,
                               int32_t *nbr_count) {
  double inv[9];
  invert3(cell, inv);
  // fractional coordinates, wrapped on periodic axes
  std::vector<double> frac(3 * n);
  for (int64_t i = 0; i < n; ++i) {
    for (int k = 0; k < 3; ++k) {
      double f = positions[3 * i + 0] * inv[0 + k] + positions[3 * i + 1] * inv[3 + k] +
                 positions[3 * i + 2] * inv[6 + k];
      if (pbc[k]) f -= std::floor(f);
      frac[3 * i + k] = f;
    }
  }
  // cell heights -> number of bins per axis
  double heights[3];
  {
    // h_k = volume / area of the face spanned by the other two vectors
    auto cross = [](const double *u, const double *v, double *w) {
      w[0] = u[1] * v[2] - u[2] * v[1];
      w[1] = u[2] * v[0] - u[0] * v[2];
      w[2] = u[0] * v[1] - u[1] * v[0];
    };
    double vol = 0, w[3];
    cross(cell + 3, cell + 6, w);
    vol = std::fabs(cell[0] * w[0] + cell[1] * w[1] + cell[2] * w[2]);
    for (int k = 0; k < 3; ++k) {
      const double *u = cell + 3 * ((k + 1) % 3);
      const double *v = cell + 3 * ((k + 2) % 3);
      cross(u, v, w);
      double area = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
      heights[k] = vol / area;
    }
  }
  int nb[3];
  for (int k = 0; k < 3; ++k) {
    nb[k] = (int)std::floor(heights[k] / cutoff);
    if (nb[k] < 1) nb[k] = 1;
    if (nb[k] > 64) nb[k] = 64;
  }
  const int nbins = nb[0] * nb[1] * nb[2];
  std::vector<std::vector<int32_t>> bins(nbins);
  auto bin_of = [&](int64_t i) {
    int bx = (int)(frac[3 * i + 0] * nb[0]);
    int by = (int)(frac[3 * i + 1] * nb[1]);
    int bz = (int)(frac[3 * i + 2] * nb[2]);
    if (bx >= nb[0]) bx = nb[0] - 1;
    if (by >= nb[1]) by = nb[1] - 1;
    if (bz >= nb[2]) bz = nb[2] - 1;
    if (bx < 0) bx = 0;
    if (by < 0) by = 0;
    if (bz < 0) bz = 0;
    return (bx * nb[1] + by) * nb[2] + bz;
  };
  for (int64_t i = 0; i < n; ++i) bins[bin_of(i)].push_back((int32_t)i);

  const double cut2 = cutoff * cutoff;
  int64_t max_count = 0;
  // wrapped cartesian positions
  std::vector<double> wpos(3 * n);
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k)
      wpos[3 * i + k] = frac[3 * i + 0] * cell[0 + k] + frac[3 * i + 1] * cell[3 + k] +
                        frac[3 * i + 2] * cell[6 + k];

  for (int64_t i = 0; i < n; ++i) {
    int bx = (int)(frac[3 * i + 0] * nb[0]);
    int by = (int)(frac[3 * i + 1] * nb[1]);
    int bz = (int)(frac[3 * i + 2] * nb[2]);
    int64_t count = 0;
    // scan neighbor bins (and their periodic images)
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          int cx = bx + dx, cy = by + dy, cz = bz + dz;
          double sx = 0, sy = 0, sz = 0;  // image shift in fractional units
          if (pbc[0]) {
            if (cx < 0) { cx += nb[0]; sx = -1; }
            if (cx >= nb[0]) { cx -= nb[0]; sx = 1; }
          }
          if (pbc[1]) {
            if (cy < 0) { cy += nb[1]; sy = -1; }
            if (cy >= nb[1]) { cy -= nb[1]; sy = 1; }
          }
          if (pbc[2]) {
            if (cz < 0) { cz += nb[2]; sz = -1; }
            if (cz >= nb[2]) { cz -= nb[2]; sz = 1; }
          }
          if (cx < 0 || cx >= nb[0] || cy < 0 || cy >= nb[1] || cz < 0 || cz >= nb[2])
            continue;
          double shift[3];
          for (int k = 0; k < 3; ++k)
            shift[k] = sx * cell[0 + k] + sy * cell[3 + k] + sz * cell[6 + k];
          for (int32_t j : bins[(cx * nb[1] + cy) * nb[2] + cz]) {
            double d0 = wpos[3 * i + 0] - (wpos[3 * j + 0] + shift[0]);
            double d1 = wpos[3 * i + 1] - (wpos[3 * j + 1] + shift[1]);
            double d2 = wpos[3 * i + 2] - (wpos[3 * j + 2] + shift[2]);
            double r2 = d0 * d0 + d1 * d1 + d2 * d2;
            if (r2 >= cut2 || r2 < 1e-20) continue;  // skips self at zero shift
            if (count < max_neighbors) {
              nbr_idx[i * max_neighbors + count] = j;
              double *out = nbr_disp + (i * max_neighbors + count) * 3;
              out[0] = d0;
              out[1] = d1;
              out[2] = d2;
            }
            ++count;
          }
        }
    nbr_count[i] = (int32_t)(count < max_neighbors ? count : max_neighbors);
    if (count > max_count) max_count = count;
  }
  return max_count;
}

// Minimum pair distance among selected atoms (MIC over nearest images).
// Used by the distance filter over large sampled trajectories
// (mcmc/utils/misc.py:118 filter_distances analog). Returns the minimum
// distance found (or 1e30 if fewer than two selected atoms).
double sk_min_selected_distance(const double *positions, int64_t n,
                                const double *cell, const int32_t *pbc,
                                const int32_t *selected_idx, int64_t n_sel) {
  double inv[9];
  invert3(cell, inv);
  double best = 1e30;
  for (int64_t a = 0; a < n_sel; ++a) {
    for (int64_t b = a + 1; b < n_sel; ++b) {
      const double *pi = positions + 3 * selected_idx[a];
      const double *pj = positions + 3 * selected_idx[b];
      double d[3] = {pi[0] - pj[0], pi[1] - pj[1], pi[2] - pj[2]};
      double f[3];
      for (int k = 0; k < 3; ++k)
        f[k] = d[0] * inv[0 + k] + d[1] * inv[3 + k] + d[2] * inv[6 + k];
      for (int k = 0; k < 3; ++k)
        if (pbc[k]) f[k] -= std::round(f[k]);
      double c0 = f[0] * cell[0] + f[1] * cell[3] + f[2] * cell[6];
      double c1 = f[0] * cell[1] + f[1] * cell[4] + f[2] * cell[7];
      double c2 = f[0] * cell[2] + f[1] * cell[5] + f[2] * cell[8];
      double r = std::sqrt(c0 * c0 + c1 * c1 + c2 * c2);
      if (r < best) best = r;
    }
  }
  return best;
}

// Fast extended-XYZ trajectory writer: frames of identical atom count.
// numbers: (n,) Z; positions: (n_frames, n, 3). Returns 0 on success.
int32_t sk_write_xyz_frames(const char *path, const int32_t *numbers,
                            const double *positions, const double *cell,
                            int64_t n_frames, int64_t n) {
  static const char *SYM[] = {
      "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne", "Na", "Mg",
      "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca", "Sc", "Ti", "V", "Cr",
      "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge", "As", "Se", "Br", "Kr",
      "Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd",
      "In", "Sn", "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
      "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf",
      "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po",
      "At", "Rn"};
  FILE *f = std::fopen(path, "w");
  if (!f) return -1;
  for (int64_t t = 0; t < n_frames; ++t) {
    std::fprintf(f, "%lld\n", (long long)n);
    std::fprintf(f,
                 "Lattice=\"%.8f %.8f %.8f %.8f %.8f %.8f %.8f %.8f %.8f\" "
                 "Properties=species:S:1:pos:R:3\n",
                 cell[0], cell[1], cell[2], cell[3], cell[4], cell[5], cell[6],
                 cell[7], cell[8]);
    const double *p = positions + t * n * 3;
    for (int64_t i = 0; i < n; ++i) {
      int z = numbers[i];
      if (z < 0 || z > 86) z = 0;
      std::fprintf(f, "%s %.8f %.8f %.8f\n", SYM[z], p[3 * i], p[3 * i + 1],
                   p[3 * i + 2]);
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
