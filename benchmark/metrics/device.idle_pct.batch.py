"""device.idle_pct.batch: the share of the traced window in which the card ran nothing.

Source: the traced window's timeline: 100 * (1 - busy / span), busy being
the union of kernel, copy and fill intervals inside the window's span
(`timeline.idle_pct`, shared by the device.idle_pct.* readers)."""

from timeline import idle_pct


def read(rec):
    return idle_pct(rec)
