"""The device's idle share of the traced stretch: the part of its wall time in
which no kernel, copy or fill ran, in percent."""


def read(run):
    if run.stretch is None or run.stretch.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.stretch.busy_s / run.stretch.window_s)
