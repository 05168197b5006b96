#!/usr/bin/env python3
"""Where the time of the key-blocked flash kernels (rows 9-10, 20 heads of
20) goes on one NVIDIA GPU: the measurements behind their launch plan and
their division in bf16, and the parts of the f32 forward.

    python3 scripts/flash_variants.py plans
    python3 scripts/flash_variants.py division
    python3 scripts/flash_variants.py f32

plans: rows 9 and 10 (ms, CUDA events over 10 calls) at (128, 512)
  unmasked and key-masked and (32, 2048) under forced launch plans (tile,
  chunk, stage buffers), each checked against the plain version (elements
  outside the bf16 tolerance, which must be 0); then the backward's two
  kernels apart (torch.profiler) under launch_plan's own plan.
division: builds two variants of csrc/flash_bwd.cu beside the package's
  own (nvcc -Xptxas -v; prints each tensor-core kernel's registers):
  "div", a = e / den by an IEEE division per element, and "divnz", the
  same with a zero e replaced by 1 before dividing (a is 0 there). Each
  build ("base" is the source as it is) is loaded in turn and row 10 timed
  at (128, 512) under five key masks: none, all ones, 30% of keys at
  random, every 7th row fully masked, and both. The variants are made by
  rewriting the source's div_by calls; the script stops if a rewrite
  matches nothing.
f32: builds variants of csrc/flash_fwd.cu beside the package's own, each
  with one part of the f32 (CUDA-core) forward cut out, whose results are
  then wrong and only its time counts: "no_qk" (no QK^T FMAs, the scores
  stay 0), "no_max" (no block max), "no_exp" (e = s - m, no expf),
  "no_pv" (no e@V FMAs); each build ("base" is the source as it is) is
  loaded in turn and row 9 timed in f32 at (128, 512) unmasked and
  key-masked (30% of keys at random, every 7th row fully masked).
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

DIVNZ = """__device__ __forceinline__ float div_nz(float x, float den) {
  const bool live = x != 0.f && den > 0.f;
  const float q = (live ? x : 1.f) / (den > 0.f ? den : 1.f);
  return live ? q : 0.f;
}

__device__ __forceinline__ float rcp_or_zero"""
KEY_SIDE = r"div_by\(x, odd \? dq2\.y : dq2\.x, odd \? rq\.y : rq\.x\)"
QUERY_SIDE = r"div_by\((x[01]), deni\[r\], rcpi\[r\]\)"
VARIANTS = {
    "div": [(KEY_SIDE,
             "((odd ? dq2.y : dq2.x) > 0.f ? x / (odd ? dq2.y : dq2.x) "
             ": 0.f)"),
            (QUERY_SIDE, r"(deni[r] > 0.f ? \1 / deni[r] : 0.f)")],
    "divnz": [(r"__device__ __forceinline__ float rcp_or_zero", DIVNZ),
              (KEY_SIDE, "div_nz(x, odd ? dq2.y : dq2.x)"),
              (QUERY_SIDE, r"div_nz(\1, deni[r])")],
}
MASKS = ("none", "ones", "random", "full", "random_full")
# The f32 forward's parts, each cut out of flash_fwd_core_kernel by one
# rewrite (f32 mode)
F32_VARIANTS = {
    "no_qk": [(r"s\[a\]\[c\] = fmaf\(qv\[a\]\.[xyzw], kv\.[xyzw], "
               r"s\[a\]\[c\]\);", "")],
    "no_max": [(r"mx\[a\] = fmaxf\(mx\[a\], s\[a\]\[c\]\);", ";")],
    "no_exp": [(r"expf\(s\[a\]\[c\] - m_run\[a\]\)",
                "(s[a][c] - m_run[a])")],
    "no_pv": [(r"o\[at(?: \+ \d)?\] = fmaf\(s\[a\]\[c\], vv\.[xyzw], "
               r"o\[at(?: \+ \d)?\]\);", "")],
}


def inputs(n, t, mask_kind, seed=0):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(300 + seed)
    qkv = torch.randn((n, t, 1200), generator=gen, device="cuda").bfloat16()
    q, k, v = torch.split(qkv, 400, dim=-1)
    g = torch.randn((n, t, 400), generator=gen, device="cuda").bfloat16()
    mask = None
    if mask_kind != "none":
        mask = torch.ones((n, t), device="cuda")
        if "random" in mask_kind:
            mask = (torch.rand((n, t), generator=gen,
                               device="cuda") > 0.3).float()
            mask[:, -1] = 1.0
        if "full" in mask_kind:
            mask[::7] = 0.0
    return q, k, v, g, mask


def plans():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import blockwise as bw

    own = bw.launch_plan

    def forced(tile, chunk, nbuf):
        def plan(n, t, heads, d, dtype, block_kv=bw.BLOCK_KV, sms=132):
            p = own(n, t, heads, d, dtype, block_kv, sms)

            def one(launch):
                c = (min(chunk, launch.chunk) if launch.kind == "fwd"
                     else chunk)
                return launch._replace(
                    tile=tile, chunk=c, nbuf=nbuf, threads=2 * tile,
                    smem=bw.smem_bytes(launch.kind, d, 2, tile, c, nbuf))
            return p._replace(fwd=one(p.fwd), bwd_key=one(p.bwd_key),
                              bwd_query=one(p.bwd_query))
        return plan

    for n, t, mask_kind in [(128, 512, "none"), (128, 512, "random_full"),
                            (32, 2048, "none")]:
        q, k, v, g, mask = inputs(n, t, mask_kind)
        ro, rm, rden = bw.flash_fwd_reference(q, k, v, mask, 20)
        delta = bw.delta_of(g, ro, 20)
        refs = bw.flash_bwd_reference(q, k, v, mask, g, rm, rden, delta, 20)
        for plan in [(128, 256, 1), (128, 256, 2), (128, 128, 1),
                     (128, 128, 2), (64, 256, 1), (64, 128, 2)]:
            bw.launch_plan = forced(*plan)
            o = bw.flash_fwd(q, k, v, mask, 20)[0]
            grads = bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, 20)
            outside = sum(cs.n_outside(a, b, *cs.BF16_TOL)
                          for a, b in zip((o, *grads), (ro, *refs)))
            fwd = cs.time_ms(lambda: bw.flash_fwd(q, k, v, mask, 20), 10)
            bwd = cs.time_ms(lambda: bw.flash_bwd(q, k, v, mask, g, rm, rden,
                                                  delta, 20), 10)
            print("PLAN " + json.dumps({"shape": [n, t], "mask": mask_kind,
                                        "plan": plan, "fwd_ms": fwd,
                                        "bwd_ms": bwd,
                                        "outside_tol": outside}),
                  flush=True)
        bw.launch_plan = own
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, 20)
            torch.cuda.synchronize()
        split = sorted(((e.key[:60], e.self_device_time_total / 5e3)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA),
                       key=lambda kv: -kv[1])[:2]
        print("SPLIT " + json.dumps({"shape": [n, t], "mask": mask_kind,
                                     "ms": split}), flush=True)


def load(path, name):
    from newsrecommendation_tpu_torch.ops import kernels

    lib = ctypes.CDLL(path)
    for entry, sig in kernels._ENTRY_POINTS[name].items():
        for suffix in ("f32", "bf16"):
            fn = getattr(lib, f"{entry}_{suffix}")
            fn.argtypes = ([kernels._CTYPES[c] for c in sig]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def division():
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(["flash_fwd", "flash_bwd"])
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        _division(tmp, cs, bw, kernels)


def _division(tmp, cs, bw, kernels):
    builds = {"base": []}
    builds.update(VARIANTS)
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
            raise SystemExit(f"{name}: a pattern matches nothing in the "
                             "sources (their div_by calls changed)")
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels._NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(d, "libflash_bwd.so"),
             os.path.join(d, "flash_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        for kern, r in re.findall(
                r"Compiling entry function '\S*?(flash_bwd_\w+?_mma_kernel)"
                r"ILi24ELb0\S*'.*?Used (\d+) registers", log, re.S):
            regs[f"{name} {kern}"] = int(r)
    print("REGS " + json.dumps(regs), flush=True)
    for mask_kind in MASKS:
        q, k, v, g, mask = inputs(128, 512, mask_kind)
        ro, rm, rden = bw.flash_fwd_reference(q, k, v, mask, 20)
        delta = bw.delta_of(g, ro, 20)
        refs = bw.flash_bwd_reference(q, k, v, mask, g, rm, rden, delta, 20)
        for name in builds:
            kernels._libs["flash_bwd"] = load(
                os.path.join(tmp, name, "libflash_bwd.so"), "flash_bwd")
            grads = bw.flash_bwd(q, k, v, mask, g, rm, rden, delta, 20)
            differ = [cs.n_differ(a, b) for a, b in zip(grads, refs)]
            ms = cs.time_ms(lambda: bw.flash_bwd(q, k, v, mask, g, rm, rden,
                                                 delta, 20), 10)
            print("DIV " + json.dumps({"build": name, "mask": mask_kind,
                                       "bwd_ms": ms,
                                       "n_differ_dq_dk_dv": differ}),
                  flush=True)


def build_variants(tmp, kernels, name, builds):
    """Each build of ``builds`` ({label: [(pattern, replacement)]}) as a copy
    of csrc with the rewrites applied, ``name``.cu compiled from it; stops
    when a rewrite matches nothing. Returns {label: .so path}."""
    procs = {}
    for label, subs in builds.items():
        d = os.path.join(tmp, label)
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
            raise SystemExit(f"{label}: a pattern matches nothing in the "
                             "sources")
        so = os.path.join(d, f"lib{name}.so")
        procs[label] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", so,
             os.path.join(d, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {label}:\n{log[-3000:]}")
        out[label] = so
    return out


def f32_parts():
    import torch

    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import blockwise as bw
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(["flash_fwd"])
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        sos = build_variants(tmp, kernels, "flash_fwd",
                             {"base": [], **F32_VARIANTS})
        for mask_kind in ("none", "random_full"):
            _, _, _, _, mask = inputs(128, 512, mask_kind)
            gen = torch.Generator(device="cuda").manual_seed(300)
            q, k, v = torch.split(torch.randn((128, 512, 1200), generator=gen,
                                              device="cuda"), 400, dim=-1)
            for label, so in sos.items():
                kernels._libs["flash_fwd"] = load(so, "flash_fwd")
                ms = cs.time_ms(lambda: bw.flash_fwd(q, k, v, mask, 20), 10)
                print("F32 " + json.dumps({"build": label,
                                           "mask": mask_kind,
                                           "fwd_ms": ms}), flush=True)
        torch.cuda.synchronize()


def main() -> int:
    import torch

    modes = {"plans": plans, "division": division, "f32": f32_parts}
    if len(sys.argv) != 2 or sys.argv[1] not in modes or (
            not torch.cuda.is_available()):
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    modes[sys.argv[1]]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
