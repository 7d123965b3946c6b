"""The whole batched step's share of the card's peak: the bytes and
operations that the fit's step calls need (the configuration's counting
file, from its shapes and each call's PCG steps), the larger of bytes over
the bandwidth and operations over the float32 rate, over the steps' time.
It reads the same work whatever implements the step."""


def read(t):
    pk = t["peaks"]
    steps = [x for p in t["pipelines"] for x in p["steps"] if x["fit"]]
    secs = sum(x["seconds"] for x in steps)
    if not pk or not secs:
        return None
    nbytes = flops = 0
    for x in steps:
        b, f = t["counts"].step(t["cfg"], x["lanes"], x["cg_steps"])
        nbytes += b
        flops += f
    return 100.0 * max(nbytes / pk["hbm_bytes_per_s"],
                       flops / pk["f32_flops_per_s"]) / secs
