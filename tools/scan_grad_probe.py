"""Why the seeded recurrent models' bf16 gradient norm through the scans'
forward kernels (K6 / K7) parts from impl="ref"'s: a fault of the kernels,
or the models' own amplification of rounding.

    python3 tools/scan_grad_probe.py          # from the repository root, one GPU
    python3 tools/scan_grad_probe.py --cpu    # the smoke configs on the CPU

For rwkv6-1.6b at 8 of its 24 layers and zamba2-2.7b at 18 of its 54
(full width, Model.init(seed=0), bf16, and its float32 copy), on
chip_smoke.numpy_batch's 4 x 2048 tokens, one loss and backward (remat
full) each of these ways:

  r16 / r32   impl="ref", bf16 / float32
  k16 / k32   the kernels (impl=None), bf16 / float32
  kscan16     the scan's kernels, every other layer impl="ref"
  kf_rb16     the scan's forward kernel, its plain backward
  rf_kb16     the scan's plain forward, its backward kernel
  x16, naive16, cp16
              chip_smoke.equal_scan_forwards' bf16 forwards (the float64
              output rounded once - the best a bf16 forward can give -,
              the step-by-step recurrence, the chunk-parallel form), the
              plain backward
  c<n>_16     the plain chunked forward at other chunk lengths n (the
              same float32 arithmetic summed in another order), the plain
              backward

and prints each way's loss and gradient norm, its gradients' distance
from r32's and r16's, where the first layer's |dy|^2 sits, and for some
ways, layer by layer, how far its scan output y and the gradient dy
reaching the scan lie from r16's (r32's).  Then, on r16's own scan operands of every layer (the training
batch's activations), K6 / K7's bf16 output and the plain one against the
float64 one (largest error over the largest |y|, and the share of
elements that differ from the float64 value rounded to bf16), and, on the
GPU, each scan kernel (forward and backward, bf16) called with its
outputs and scratch inside NaN-filled guard zones: the guards untouched,
every output element written and finite, the operands unchanged, and the
outputs equal, bit for bit, to the wrapper's.
"""
import argparse
import contextlib
import functools
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import mamba2_scan as m2  # noqa: E402
from repro_torch.kernels import rwkv6_scan as r6  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.train_step import trainable  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

# each arch: (layers, the scan's name in ops and in its kernel module, the
# kernel module, the plain chunked forward, other chunk lengths of it)
ARCHS = {"rwkv6-1.6b": (8, "rwkv6_scan", r6, "rwkv6_scan_chunked",
                        (16, 8, 4)),
         "zamba2-2.7b": (18, "mamba2_scan", m2, "mamba2_scan_chunked",
                         (64, 256, 32))}
GUARD = 1 << 16      # elements of each guard zone


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def tree_rel(g, g0) -> float:
    """rel over every leaf at once."""
    num = sum(float(((g[p].double() - g0[p].double()) ** 2).sum())
              for p in g0)
    den = sum(float((g0[p].double() ** 2).sum()) for p in g0)
    return math.sqrt(num / den)


class Recorder:
    """ops.<scan> wrapped while `on`: each call's operands and output y
    (detached), and the gradient dy that reaches y, in layer order (the
    forward's calls; remat's recomputations in the backward are not
    recorded).  scan_impl, when set, is the impl every scan call takes
    (the kernels inside a step whose other layers run impl="ref")."""

    def __init__(self, name):
        self.name, self.orig, self.on = name, getattr(ops, name), False
        self.calls, self.scan_impl = [], None

    def __call__(self, *args, **kw):
        if self.scan_impl is not None:
            kw["impl"] = None if self.scan_impl == "kernels" \
                else self.scan_impl
        y = self.orig(*args, **kw)
        if self.on:
            rec = {"ops": [a.detach().clone() for a in args],
                   "y": y.detach().clone(), "dy": None}
            self.calls.append(rec)
            if y.requires_grad:
                y.register_hook(lambda g, rec=rec: rec.__setitem__(
                    "dy", g.detach().clone()))
        return y

    @contextlib.contextmanager
    def recording(self, scan_impl=None):
        self.calls, self.on, self.scan_impl = [], True, scan_impl
        setattr(ops, self.name, self)
        try:
            yield self
        finally:
            self.on, self.scan_impl = False, None
            setattr(ops, self.name, self.orig)


def one_way(model, params, batch, impl, rec, ctx, scan_impl=None):
    """Loss, gradient norm, the leaves' gradients (float32) and the
    recorded scan calls of one loss and backward."""
    for q in leaves(params):
        q.grad = None
    with ctx, rec.recording(scan_impl):
        loss, _ = model.loss(params, batch, impl=impl, remat=True)
        rec.on = False
        loss.backward()
    grads = {p: q.grad.float() for p, q in leaves_with_paths(params)}
    for q in leaves(params):
        q.grad = None
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                          for g in grads.values()))
    return float(loss.detach()), gnorm, grads, rec.calls


def dy_share(calls) -> str:
    """Where |dy|^2 of the first layer's scan sits: the share at t = 0,
    and the largest share of one (sequence, step, head); and the variance
    of y over a head's channels, the least at t = 0 and the median after
    (rwkv6's per-head group norm adds 1e-5 to it)."""
    dy = calls[0]["dy"].double()
    e = (dy ** 2).sum(-1)                      # (B, S, H)
    tot = float(e.sum())
    var = calls[0]["y"].double().var(-1, unbiased=False)
    return (f"dy^2 at t=0 {float(e[:, 0].sum()) / tot:.4f}, largest "
            f"(b, t, h) {float(e.max()) / tot:.4f} at "
            f"{tuple(int(i) for i in torch.nonzero(e == e.max())[0])}; "
            f"var(y) over a head, least at t=0 {float(var[:, 0].min()):.3e}"
            f", median at t>0 {float(var[:, 1:].median()):.3e}")


def equal_forwards(cfg, chunked, chunks):
    """chip_smoke.equal_scan_forwards' bf16 forwards, and the plain
    chunked form at other chunk lengths.  {name: forward}."""
    fns = cs.equal_scan_forwards(cfg)
    for c in chunks:
        fns[f"c{c}_16"] = functools.partial(getattr(ref, chunked), chunk=c)
    return fns


def layer_accuracy(arch, mod, fwd_name, chunked, chunks, calls):
    """K6 / K7's bf16 output (the wrapper: the kernel on the GPU) and the
    plain chunked forward (at its own chunk and others) against the
    float64 output, on r16's operands of every layer: the largest error
    over the largest |y|, the share of elements off the float64 value
    rounded to bf16, and over all layers, of those elements the share
    rounded toward zero (0.5 for no bias)."""
    plain = getattr(ref, chunked)
    fns = {"kernel": getattr(mod, fwd_name), "plain": plain}
    for c in chunks:
        fns[f"plain_c{c}"] = functools.partial(plain, chunk=c)
    worst = {k: [0.0, 0.0, 0, 0] for k in fns}
    for i, call in enumerate(calls):
        a = call["ops"]
        y64 = plain(*(t.double() for t in a))
        yx = y64.to(a[0].dtype)
        top = float(y64.abs().max())
        floor = float((yx.double() - y64).abs().max()) / top
        parts = [f"layer {i}: max|y| {top:.4g}, rounding floor {floor:.3e}"]
        for name, fn in fns.items():
            y = fn(*a)
            err = float((y.double() - y64).abs().max()) / top
            off = y != yx
            share = float(off.double().mean())
            n_tz = int((y[off].double().abs() < yx[off].double().abs())
                       .sum())
            w = worst[name]
            worst[name] = [max(w[0], err), max(w[1], share),
                           w[2] + int(off.sum()), w[3] + n_tz]
            parts.append(f"{name} {err:.3e} / {share:.4f}")
        print(arch, "fwd-acc", "; ".join(parts), flush=True)
    print(arch, "fwd-acc over the layers (largest error, largest share "
          "off the rounded float64, elements off it, share of those "
          "rounded toward zero):",
          {k: (f"{e:.3e}", f"{o:.4f}", n, f"{z / max(n, 1):.4f}")
           for k, (e, o, n, z) in worst.items()}, flush=True)


def _guarded(n, dtype, dev):
    return torch.full((n + 2 * GUARD,), float("nan"), dtype=dtype,
                      device=dev)


def _payload(buf, shape):
    return buf[GUARD:GUARD + math.prod(shape)].view(shape)


def _intact(buf) -> bool:
    return bool(torch.isnan(buf[:GUARD]).all()
                and torch.isnan(buf[-GUARD:]).all())


def guard_check(arch, mod, fwd_name, call):
    """The forward and backward kernel of one layer's operands (r16's),
    raw, with every output and scratch buffer inside NaN guards."""
    a = [t.contiguous() for t in call["ops"]]
    dy = call["dy"].to(a[0].dtype).contiguous()
    before = [t.clone() for t in a]
    stream = torch.cuda.current_stream().cuda_stream
    dev = a[0].device
    ok = {}
    if mod is r6:
        r, k, v, w, u = a
        Bsz, S, H, K = r.shape
        V = v.shape[-1]
        nc = -(-S // r6.CHUNK)
        yb = _guarded(v.numel(), v.dtype, dev)
        sb = _guarded(Bsz * H * nc * 2 * K * V, torch.bfloat16, dev)
        build.check("rwkv6_scan", build.kernel("rwkv6_scan")(
            *(t.data_ptr() for t in a), _payload(yb, v.shape).data_ptr(),
            _payload(sb, (sb.numel() - 2 * GUARD,)).data_ptr(), Bsz, S, H,
            K, V, 1, stream))
        y_w = r6.rwkv6_scan(*a)
        outs = {"y": (yb, v.shape, y_w)}
        gb = [_guarded(t.numel(), t.dtype, dev) for t in a]
        scr = [_guarded(t.numel(), t.dtype, dev) for t in r6.bwd_scratch(
            Bsz, S, H, K, V, torch.bfloat16, dev)]
        build.check("rwkv6_scan_bwd", build.kernel("rwkv6_scan_bwd")(
            *(t.data_ptr() for t in a), dy.data_ptr(),
            *(_payload(b, t.shape).data_ptr() for b, t in zip(gb, a)),
            *(_payload(b, (b.numel() - 2 * GUARD,)).data_ptr()
              for b in scr), Bsz, S, H, K, V, 1, stream))
        g_w = r6.rwkv6_scan_bwd(*a, dy)
        for name, b, t, gw in zip(("dr", "dk", "dv", "dw", "du"), gb, a,
                                  g_w):
            outs[name] = (b, t.shape, gw)
    else:
        x, dt, A, Bm, Cm = a
        Bsz, S, H, P = x.shape
        N = Bm.shape[-1]
        nc = -(-S // m2.CHUNK)
        yb = _guarded(x.numel(), x.dtype, dev)
        sb = _guarded(Bsz * H * nc * 2 * P * N, torch.bfloat16, dev)
        build.check("mamba2_scan", build.kernel("mamba2_scan")(
            *(t.data_ptr() for t in a), _payload(yb, x.shape).data_ptr(),
            _payload(sb, (sb.numel() - 2 * GUARD,)).data_ptr(), Bsz, S, H,
            P, N, 1, stream))
        y_w = m2.mamba2_scan(*a)
        outs = {"y": (yb, x.shape, y_w)}
        gb = [_guarded(t.numel(), t.dtype, dev) for t in a]
        scr = [_guarded(t.numel(), t.dtype, dev) for t in m2.bwd_scratch(
            Bsz, S, H, P, N, torch.bfloat16, dev)]
        # the kernel's output order: dx, ddt, dA, dBm, dCm
        build.check("mamba2_scan_bwd", build.kernel("mamba2_scan_bwd")(
            *(t.data_ptr() for t in a), dy.data_ptr(),
            *(_payload(b, t.shape).data_ptr() for b, t in zip(gb, a)),
            *(_payload(b, (b.numel() - 2 * GUARD,)).data_ptr()
              for b in scr), Bsz, S, H, P, N, 1, stream))
        g_w = m2.mamba2_scan_bwd(*a, dy)
        for name, b, t, gw in zip(("dx", "ddt", "dA", "dBm", "dCm"), gb, a,
                                  g_w):
            outs[name] = (b, t.shape, gw)
    torch.cuda.synchronize()
    ok["scratch guards"] = all(_intact(b) for b in [sb] + scr)
    for name, (b, shape, w) in outs.items():
        p = _payload(b, shape)
        ok[name] = (_intact(b), bool(torch.isfinite(p).all()),
                    bool(torch.equal(p, w)))
    ok["operands unchanged"] = all(torch.equal(t, t0)
                                   for t, t0 in zip(a, before))
    print(arch, "guards (guards intact, all written and finite, equal to "
          "the wrapper's):", ok, flush=True)


def probe(arch, device, cuda):
    layers, fwd_name, mod, chunked, chunks = ARCHS[arch]
    if cuda:
        cfg = get_config(arch).replace(n_layers=layers)
        B, S = 4, 2048
    else:
        cfg = get_smoke_config(arch)
        B, S = 2, 40
    model = build_model(cfg, device=device)
    params = trainable(model.init(seed=0))
    m32, p32 = cs.fp32_copy(model, params)
    trainable(p32)
    batch = cs.numpy_batch(cfg, B, S, model.device)
    rec = Recorder(fwd_name)
    null = contextlib.nullcontext
    base = {"r32": one_way(m32, p32, batch, "ref", rec, null()),
            "r16": one_way(model, params, batch, "ref", rec, null())}
    # (name, model, params, impl, context, scan_impl)
    ways = [("k16", model, params, None, null(), None),
            ("k32", m32, p32, None, null(), None),
            ("kscan16", model, params, "ref", null(), "kernels"),
            ("kf_rb16", model, params, None,
             cs.scan_swapped(cfg, bwd=mod.reference_bwd), None),
            ("rf_kb16", model, params, None,
             cs.scan_swapped(cfg, fwd=mod.reference), None)]
    for name, fn in equal_forwards(cfg, chunked, chunks).items():
        ways.append((name, model, params, None,
                     cs.scan_swapped(cfg, fwd=fn, bwd=mod.reference_bwd),
                     None))
    g32, g16 = base["r32"][2], base["r16"][2]
    rows = {}
    for name, m, p, impl, ctx, scan_impl in [
            ("r32",) + (None,) * 5, ("r16",) + (None,) * 5] + ways:
        res = base[name] if name in base else \
            one_way(m, p, batch, impl, rec, ctx, scan_impl)
        loss, gnorm, grads, calls = res
        print(arch, name, f"loss {loss:.6f} gnorm {gnorm:.4f}; gradients "
              f"vs r32 {tree_rel(grads, g32):.3f}, vs r16 "
              f"{tree_rel(grads, g16):.3f}; {dy_share(calls)}", flush=True)
        if name in ("k16", "k32", "x16", "rf_kb16"):
            yref = base["r32" if name.endswith("32") else "r16"][3]
            print(arch, name, "layer by layer vs",
                  "r32" if name.endswith("32") else "r16", "(y, dy):",
                  [(f"{rel(c['y'], c0['y']):.2e}",
                    f"{rel(c['dy'], c0['dy']):.2e}")
                   for c, c0 in zip(calls, yref)], flush=True)
        rows[name] = (loss, gnorm)
        del grads, calls, res
        cs._free()
    print(arch, "r16 vs r32 layer by layer (y, dy):",
          [(f"{rel(c['y'].float(), c0['y']):.2e}",
            f"{rel(c['dy'].float(), c0['dy']):.2e}")
           for c, c0 in zip(base["r16"][3], base["r32"][3])], flush=True)
    calls = base["r16"][3]
    base = None
    cs._free()
    layer_accuracy(arch, mod, fwd_name, chunked, chunks, calls)
    if cuda:
        guard_check(arch, mod, fwd_name, calls[0])
        guard_check(arch, mod, fwd_name, calls[-1])
    print(arch, "summary (loss, gnorm):",
          {k: (round(a, 6), round(b, 4)) for k, (a, b) in rows.items()},
          flush=True)
    del model, params, m32, p32, calls
    cs._free()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="the smoke configs on the CPU (plain versions)")
    args = ap.parse_args()
    cuda = not args.cpu
    if cuda:
        cs.phase_device_and_build()
        torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda" if cuda else "cpu"
    for arch in ARCHS:
        probe(arch, device, cuda)


if __name__ == "__main__":
    main()
