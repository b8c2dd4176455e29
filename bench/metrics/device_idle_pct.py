"""device_idle_pct (device trace; the device, one stream): 100 less the
share of the traced window covered by the union of the device's kernel,
copy and set intervals."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_us() / 1e6 / tr.window_s)
