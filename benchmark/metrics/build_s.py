"""Seconds of the system build (spec, static tables, bands, potential,
delta tables): the host span around the port's builder call."""


def read(ctx):
    return ctx["setup"]["build_s"]
