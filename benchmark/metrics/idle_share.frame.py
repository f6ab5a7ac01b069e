"""Share of the traced window in which no operation ran on the card (%):
1 − the union of the device intervals ÷ the window."""


def read(tr):
    return tr.idle_share()
