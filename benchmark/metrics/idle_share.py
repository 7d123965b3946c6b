"""Share of the profiled window in which nothing ran on the device: one
less the union of the kernel, copy and set intervals over the window."""


def read(t):
    d = t["device"]
    if not d or not d["busy_s"]:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
