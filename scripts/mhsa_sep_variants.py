#!/usr/bin/env python3
"""Where the time of rows 6 and 8's resident kernel (the separate-q/k/v
backward at T <= 64, csrc/mhsa_sep_bwd.cuh) and of rows 5 and 7 on tensor
cores (the forward past T = 64 in bf16, csrc/mhsa_sep_fwd.cuh) goes on
one NVIDIA GPU: the measurements behind their launch plans and designs.

    python3 scripts/mhsa_sep_variants.py plans
    python3 scripts/mhsa_sep_variants.py cuts
    python3 scripts/mhsa_sep_variants.py fwd

plans: rows 6 and 8 (ms, CUDA events over 10 calls) at (7040, 20), 20
  heads, d_k 20, d_v 32, bf16 and f32, unmasked and key-masked, under
  forced resident plans (heads an item, stage buffers, blocks per SM),
  each checked against the plain version (elements outside the smoke's
  tolerance, which must be 0); beside them row 16 at d = 20 and 32 under
  its own plan, the same design on one fused projection.
cuts: builds variants of csrc/mhsa_sep.cu beside the package's own, each
  with one part of the resident kernel cut out ("rows": the per-query
  pass that writes round(a) and ds; "sums": the dq, dk, dv sums; "widen":
  the f32 copies of K and V), loads each in turn and times rows 6 and 8
  at (7040, 20) under the default plan. A cut variant computes wrong
  gradients; only its time is read. The script stops if a cut matches
  nothing in the source.
fwd: rows 5 and 7 (ms, CUDA events over 10 calls) at (64, 511) and
  (128, 300), 20 heads, d_k 20, d_v 32, bf16, unmasked and key-masked,
  on tensor cores under forced forms of their plan (chunks of 256 keys in
  one buffer, 128 and 64 in two), each checked against the plain version
  (elements outside the smoke's tolerance, which must be 0).
Run from the repo root. Prints one line per measurement; exits 1 without
CUDA.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

N, T, HEADS, DK, DV = 7040, 20, 20, 20, 32
CUTS = {
    "rows": [(r"for \(int task = warp; task < it\.gn \* p\.t;",
              "for (int task = warp; task < 0;")],
    "sums": [(r"for \(int idx = threadIdx\.x; idx < n_all;",
              "for (int idx = threadIdx.x; idx < 0;")],
    "widen": [(r"widen\(kf, ks, it\.gn, p\);\s*widen\(vf, vs, it\.gn, p\);",
               "")],
}


def inputs(dtype, masked, dv=DV, seed=5):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    hdk, hdv = HEADS * DK, HEADS * dv
    proj = torch.randn((N, T, 2 * hdk + hdv), generator=gen,
                       device="cuda").to(dtype)
    q, k, v = torch.split(proj, [hdk, hdk, hdv], dim=-1)
    g = torch.randn((N, T, hdv), generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = (torch.rand((N, T), generator=gen, device="cuda") > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    return q, k, v, g, mask


def plans():
    import torch

    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(["mhsa_sep", "blanes"])
    default = fa.sep_bwd_launch_plan
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        itemsize = 2 if dtype == torch.bfloat16 else 4
        b_rtol, b_atol = cs.TRAIN_TOL[name][1]
        for masked in (False, True):
            q, k, v, g, mask = inputs(dtype, masked)
            refs = fa.exp_mhsa_bwd_reference(q, k, v, mask, g, HEADS)
            base = default(N, T, HEADS, DK, DV, dtype)
            for heads in (4, 2, 1):
                for nbuf in (2, 1):
                    smem = bl.smem_bytes("bwd", T, DV, itemsize, heads, T,
                                         nbuf)
                    items = N * -(-HEADS // heads)
                    for per_sm in (2, 3, 4):
                        plan = base._replace(resident=bl.Plan(
                            "bwd", heads, T, nbuf, items, 132 * per_sm,
                            smem))
                        fa.sep_bwd_launch_plan = (
                            lambda *a, _plan=plan, **kw: _plan)
                        try:
                            def fn():
                                return fa.mhsa_sep_bwd(q, k, v, mask, g,
                                                       HEADS)

                            bad = sum(cs.n_outside(x, r, b_rtol, b_atol)
                                      for x, r in zip(fn(), refs))
                            ms = cs.time_ms(fn, 10)
                        finally:
                            fa.sep_bwd_launch_plan = default
                        print("PLAN " + json.dumps({
                            "dtype": name, "masked": masked, "heads": heads,
                            "nbuf": nbuf, "blocks_per_sm": per_sm,
                            "smem": smem, "ms": ms, "outside": bad,
                            "default": plan.resident == base.resident}),
                            flush=True)
            for d in (DK, DV):
                qkv = torch.randn((N, T, 3 * HEADS * d), device="cuda").to(
                    dtype)
                gg = torch.randn((N, T, HEADS * d), device="cuda").to(dtype)
                print("ROW16 " + json.dumps({
                    "dtype": name, "masked": masked, "d": d,
                    "ms": cs.time_ms(lambda: bl.blanes_bwd(
                        qkv, mask, gg, HEADS), 10)}), flush=True)


def fwd():
    import torch

    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import fused_attention as fa

    default = fa.sep_fwd_launch_plan
    f_rtol, f_atol = cs.TRAIN_TOL["bfloat16"][0]
    for n, t in ((64, 511), (128, 300)):
        base = default(n, t, HEADS, DK, DV, torch.bfloat16)
        plans = [base._replace(launch=base.launch._replace(
            chunk=chunk, nbuf=nbuf, smem=bw.smem_bytes(
                "fwd", DV, 2, base.launch.tile, chunk, nbuf)))
            for chunk, nbuf in ((256, 1), (128, 2), (64, 2))]
        for masked in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(5)
            hdk, hdv = HEADS * DK, HEADS * DV
            proj = torch.randn((n, t, 2 * hdk + hdv), generator=gen,
                               device="cuda").to(torch.bfloat16)
            q, k, v = torch.split(proj, [hdk, hdk, hdv], dim=-1)
            mask = None
            if masked:
                mask = (torch.rand((n, t), generator=gen,
                                   device="cuda") > 0.3).float()
            ref = fa.exp_mhsa_reference(q, k, v, mask, HEADS)
            for plan in plans:
                fa.sep_fwd_launch_plan = lambda *a, _plan=plan, **kw: _plan
                try:
                    def fn():
                        return fa.mhsa_sep_fwd(q, k, v, mask, HEADS)

                    bad = cs.n_outside(fn(), ref, f_rtol, f_atol)
                    ms = cs.time_ms(fn, 10)
                finally:
                    fa.sep_fwd_launch_plan = default
                p = plan.launch
                print("FWD " + json.dumps({
                    "shape": [n, t], "masked": masked, "tile": p.tile,
                    "chunk": p.chunk, "nbuf": p.nbuf, "smem": p.smem,
                    "ms": ms, "outside": bad, "default": plan == base}),
                    flush=True)


def load(path):
    from newsrecommendation_tpu_torch.ops import kernels

    lib = ctypes.CDLL(path)
    for entry, sig in kernels._ENTRY_POINTS["mhsa_sep"].items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{entry}_{suffix}")
            fn.argtypes = ([kernels._CTYPES[c] for c in sig]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    for fn_name, n_ints in kernels._SIZE_FUNCTIONS["mhsa_sep"].items():
        getattr(lib, fn_name).argtypes = [ctypes.c_int] * n_ints
    return lib


def cuts():
    import torch

    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    builds = {"base": []}
    builds.update(CUTS)
    with tempfile.TemporaryDirectory(prefix="mhsa_sep_variants_") as tmp:
        procs = {}
        for name, subs in builds.items():
            d = os.path.join(tmp, name)
            os.makedirs(d)
            hits = [0] * len(subs)
            for f in os.listdir(kernels._CSRC):
                with open(os.path.join(kernels._CSRC, f)) as fh:
                    src = fh.read()
                for i, (pattern, repl) in enumerate(subs):
                    src, n = re.subn(pattern, repl, src)
                    hits[i] += n
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(src)
            if not all(hits):
                raise SystemExit(f"{name}: a cut matches nothing in the "
                                 "sources")
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels._NVCC_FLAGS, "-o",
                 os.path.join(d, "libmhsa_sep.so"),
                 os.path.join(d, "mhsa_sep.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                q, k, v, g, mask = inputs(dtype, masked)
                for name in builds:
                    kernels._libs["mhsa_sep"] = load(
                        os.path.join(tmp, name, "libmhsa_sep.so"))
                    ms = cs.time_ms(lambda: fa.mhsa_sep_bwd(
                        q, k, v, mask, g, HEADS), 10)
                    print("CUT " + json.dumps({
                        "build": name, "dtype": str(dtype).split(".")[1],
                        "masked": masked, "ms": ms}), flush=True)


def main() -> int:
    import torch

    modes = {"plans": plans, "cuts": cuts, "fwd": fwd}
    if len(sys.argv) != 2 or sys.argv[1] not in modes or (
            not torch.cuda.is_available()):
        print(__doc__, file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    modes[sys.argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
