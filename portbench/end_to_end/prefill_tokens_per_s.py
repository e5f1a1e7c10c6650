"""Prompt tokens of every request the window completed, over the window's
seconds."""


def read(w):
    return sum(u["b"] * u["t"] for u in w.units) / w.window_s
