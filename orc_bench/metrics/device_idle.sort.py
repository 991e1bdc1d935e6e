"""device_idle.sort: the device's idle share of the traced window, 100%
less the union of its kernel, copy and set intervals over the window,
in %."""


def read(layer):
    t = layer.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
