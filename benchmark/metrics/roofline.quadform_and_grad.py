"""Share of its HBM bound that the fused kernel (``spectrum_quadform_and_grad``,
the PCG step's operator) reaches: the bytes its launches need (from each
launch's shape), over the card's bandwidth, over the kernel's device time
in the profiled window."""

KIND = "quadform_and_grad"


def read(t):
    d, pk = t["device"], t["peaks"]
    if not d or not pk:
        return None
    secs = d["kernel_s"].get(KIND, 0.0)
    nbytes = sum(t["counts"].kernel_bytes(k, s) for k, s in t["launches"]
                 if k == KIND)
    if not secs or not nbytes:
        return None
    return 100.0 * nbytes / pk["hbm_bytes_per_s"] / secs
