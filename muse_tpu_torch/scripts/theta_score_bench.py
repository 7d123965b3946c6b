"""The field GRF's batched θ-score, route by route: device time, profile,
launches and error.

``grf_field_problem``'s per-lane θ-score, evaluated for a batch of lanes
under ``torch.func.vmap`` as the solver evaluates it in every muse step,
goes one of four routes:

  * ``grad_kernel``: ``vmap(grad(log_like))`` with ``use_pallas=True``:
    the quadform kernel's forward and :class:`SpectrumQuadform`'s plain
    torch backward;
  * ``grad_plain``: the same with ``use_pallas=False``: the autograd of
    the plain ``einsum`` quadform;
  * ``analytic_kernel``: ``vmap(prob.grad_theta_log_like)`` with
    ``use_pallas=True``: ½Q/n² − ½Σw from one ``spectrum_quadforms``
    launch, no backward;
  * ``analytic_plain``: the same with ``use_pallas=False``: the plain
    ``spectrum_quadforms``.

The analytic routes exist where the problem has ``grad_theta_log_like``,
and the launches count ``spectrum_quadforms_cuda`` where it exists: the
script runs unchanged on a tree from before the analytic score too, for
a reading before and after on one card.
Per route: the device milliseconds of one batched evaluation (CUDA
events around back-to-back evaluations, the median of ``--samples``), a
``torch.profiler`` table of the device operations of one evaluation, the
quadform kernel's launches per evaluation, and the largest error of a
lane's score against a float64 evaluation of the formula, relative to
the size of its two cancelling terms, ½Q/n² + ½Σw. The lanes are drawn by
the problem's sampler at θ = 0.5 from seeds 0, 1, ...

Run:  python -m muse_tpu_torch.scripts.theta_score_bench [--n 1024 --lanes 101]
      (add --device cpu to run on the CPU, at a small --n: errors and
      launches only, the times "not measured")
"""

import argparse
import statistics

import torch
from torch.func import grad, vmap

from muse_tpu_torch.models import grf_field_problem
from muse_tpu_torch.ops import grf_spectrum as gs
from muse_tpu_torch.utils import resolve_device
from muse_tpu_torch.utils.keys import lane_generator

ROUTES = ("grad_kernel", "grad_plain", "analytic_kernel", "analytic_plain")


def quad_launches() -> int:
    """The quadform kernel's launches through both of its wrappers."""
    return gs.spectrum_quadform_cuda.launches + getattr(
        getattr(gs, "spectrum_quadforms_cuda", None), "launches", 0)


def score_routes(n=1024, lanes=101, sigma_noise=0.01, theta=0.5,
                 device="cuda"):
    """(lanes' x, lanes' z, θ tensor, {route: batched score function}, the
    kernel route's problem) at this size."""
    dev = resolve_device(device)
    probs = {flag: grf_field_problem(n=n, sigma_noise=sigma_noise,
                                     data_seed=42, use_pallas=flag,
                                     device=dev)
             for flag in (True, False)}
    xs, zs = map(torch.stack, zip(*(probs[True].sample_x_z(
        lane_generator(s, dev), theta) for s in range(lanes))))
    th = torch.tensor(theta, device=dev)
    routes = {}
    for flag, name in ((True, "kernel"), (False, "plain")):
        p = probs[flag]
        routes[f"grad_{name}"] = (lambda p=p: vmap(lambda a, b: grad(
            lambda t: p.log_like(a, b, t))(th))(xs, zs))
        if p.grad_theta_log_like is not None:
            routes[f"analytic_{name}"] = (lambda p=p: vmap(
                lambda a, b: p.grad_theta_log_like(a, b, th))(xs, zs))
    return xs, zs, th, routes, probs[True]


def float64_score(prob, zs, theta):
    """(the lanes' scores ½Q/n² − ½Σw in float64, the size of their terms
    ½Q/n² + ½Σw)."""
    cfg = prob.grf_config
    C = cfg.spectrum(theta).double()
    w = cfg.herm_weight.double()
    q = gs.spectrum_quadform_plain(gs.pack_rfft2(zs.double()),
                                   gs.pack_weights(w / C)) / cfg.n ** 2
    return 0.5 * (q - w.sum()), 0.5 * (q + w.sum())


def device_ms(fn, samples=20, per_sample=5):
    """Median device ms of one call of ``fn``: CUDA events around
    ``per_sample`` back-to-back calls, ``samples`` times."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return statistics.median(times), times


def device_profile(fn, nevals=3, top=8):
    """(device ms of one evaluation summed over its kernels, the ``top``
    kernels as (name, ms per evaluation, launches per evaluation)), from
    ``torch.profiler`` over ``nevals`` evaluations; (None, []) when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(nevals):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / nevals
    if busy <= 0:
        return None, []
    rows = [(e.key, e.self_device_time_total / 1e3 / nevals,
             e.count / nevals)
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)]
    return busy, rows[:top]


def run(n=1024, lanes=101, sigma_noise=0.01, samples=20, device="cuda"):
    """Every route's {"ms", "ms_samples", "profile_ms", "top", "launches",
    "rel_err", "rel_vs_grad", "score"}: ``rel_vs_grad`` is its largest
    distance from the ``grad_kernel`` route's scores, relative to the
    terms as ``rel_err``; the times are None off a card."""
    xs, zs, th, routes, prob = score_routes(n, lanes, sigma_noise,
                                            device=device)
    on_card = xs.is_cuda
    g64, scale = float64_score(prob, zs, th)
    out = {}
    for name, fn in routes.items():
        before = quad_launches()
        g = fn()
        launches = quad_launches() - before
        rel = ((g.double() - g64).abs() / scale).max().item()
        ms = ms_samples = busy = None
        top = []
        if on_card:
            ms, ms_samples = device_ms(fn, samples=samples)
            busy, top = device_profile(fn)
        out[name] = {"ms": ms, "ms_samples": ms_samples, "profile_ms": busy,
                     "top": top, "launches": launches, "rel_err": rel,
                     "score": g}
    # every route against the main path's route before the analytic score
    ref = out["grad_kernel"]["score"].double()
    for r in out.values():
        r["rel_vs_grad"] = ((r["score"].double() - ref).abs()
                            / scale).max().item()
    return out


def report(out, n, lanes, emit=print):
    """Print each route's lines; ``emit`` takes one line."""
    for name, r in out.items():
        ms = "not measured" if r["ms"] is None else f"{r['ms']:.4f} ms"
        prof = ("not measured" if r["profile_ms"] is None
                else f"{r['profile_ms']:.4f} ms")
        spread = ("" if r["ms_samples"] is None else
                  f"; samples {min(r['ms_samples']):.4f}-"
                  f"{max(r['ms_samples']):.4f} ms")
        emit(f"{name}: {ms} per batched θ-score ({lanes} lanes × "
             f"{n}²{spread}); profiled device time {prof}; "
             f"{r['launches']} quadform kernel launches; max |Δg| / (½Q/n² "
             f"+ ½Σw) vs float64 {r['rel_err']:.3e}, vs grad_kernel "
             f"{r['rel_vs_grad']:.3e}")
        for key, ms_k, count in r["top"]:
            emit(f"  {ms_k:8.4f} ms {count:4.1f}x  {key[:100]}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m muse_tpu_torch.scripts.theta_score_bench")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--lanes", type=int, default=101)
    ap.add_argument("--sigma-noise", type=float, default=0.01)
    ap.add_argument("--samples", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run every route and print its lines; returns :func:`run`'s dict."""
    args = parse_args(argv)
    out = run(args.n, args.lanes, args.sigma_noise, args.samples,
              args.device)
    report(out, args.n, args.lanes, emit=lambda s: print(s, flush=True))
    return out


if __name__ == "__main__":
    main()
