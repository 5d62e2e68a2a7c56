"""Share of the traced window with no operation on the device."""
from perfbench.reading import idle_pct


def read(trace):
    return idle_pct(trace)
