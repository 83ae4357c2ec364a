"""Share of the traced time with no kernel or copy on the device."""

from gpubench.readers import idle_share


def read(trace):
    return idle_share(trace)
