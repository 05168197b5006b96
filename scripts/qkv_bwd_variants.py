#!/usr/bin/env python3
"""Where the time of rows 3-4's short resident kernel (csrc/qkv_bwd.cuh,
namespace qb; T <= 64, heads of up to 32) goes on one NVIDIA GPU, at the
news encoder's (7040, 20), 20 heads of 20.

    python3 scripts/qkv_bwd_variants.py parts
    python3 scripts/qkv_bwd_variants.py plans
    python3 scripts/qkv_bwd_variants.py shape
    python3 scripts/qkv_bwd_variants.py batch

parts: builds variants of csrc/qkv_bwd_probs.cu (row 3) and csrc/qkv_bwd.cu
  (row 4) beside the package's own, each with parts of the kernel cut out,
  whose results are then wrong and only their time counts: "stage" (the
  walk over the items and their copies alone), "prep" (also the f32 rows:
  the bf16 widening, the f32 bias), "no_a" (all but phase A: round(a), ds
  and ds^T, and row 4's a), "no_b" (all but phase B: the products dq, dk,
  dv), and without the copies ("no_copy": the compute alone, on whatever
  shared memory holds; "no_copy_prep": the f32 rows alone; "no_copy_empty":
  the walk and its barriers alone); "base" is the source as it is. Each
  row is timed (ms, CUDA events over 20 calls) in both dtypes.
plans: rows 3 and 4 under forced plans (heads an item 1-5, one or two
  stage buffers, where a block fits), each with the hash of its output,
  which a plan must not change.
shape: variants built for two ("b2") and three ("b3") blocks an SM
  (__launch_bounds__; the source builds row 3 for three, row 4 for two),
  each under plans of 4 heads, one or two stage buffers and as many blocks
  as the build is for, with the hash of each output.
batch: variants with phase A's batches of 3, 5 (the source) and 10 rows
  where a lane holds one key, each under the row's own plan, with the hash
  of each output.
Run from the repo root. Prints one line per measurement; exits 1 without
CUDA.
"""

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())

COMPUTE = r"auto compute = \[&\]\(int item, int b\) \{"
COMPUTE_CUT = r"auto compute = [&](int item, int b) { return;"
STAGE = r"auto stage = \[&\]\(int item, int b\) \{\n    stage_item<"
STAGE_CUT = r"auto stage = [&](int item, int b) { return;\n    stage_item<"
PARTS = {
    "stage": [(COMPUTE, COMPUTE_CUT)],
    "prep": [(r"__syncthreads\(\);  // the f32 rows are in",
              "__syncthreads();  // the f32 rows are in\n    return;")],
    "no_a": [(r"(recompute_rows<DM, NS, RB>\(|ds_rows<T, DM, NS, RB>\()",
              r"if (false) \1")],
    "no_b": [(r"sum_products<T>\(dqkv, arr, w, it, p\);", ";")],
    "no_copy": [(STAGE, STAGE_CUT)],
    "no_copy_prep": [(STAGE, STAGE_CUT),
                     (r"__syncthreads\(\);  // the f32 rows are in",
                      "__syncthreads();  // the f32 rows are in\n    return;")],
    "no_copy_empty": [(STAGE, STAGE_CUT), (COMPUTE, COMPUTE_CUT)],
}
SHAPES = {f"b{b}": [(r"__launch_bounds__\(kThreads, blocks_per_sm\(kRecompute\)\)",
                     f"__launch_bounds__(kThreads, {b})")]
          for b in (2, 3)}
BATCHES = {f"rb{r}": [(r"return NS == 1 \? 5 : 3;",
                       f"return NS == 1 ? {r} : 3;")]
           for r in (3, 10)}
ROWS = ("qkv_bwd_probs", "qkv_bwd")


def build_variants(tmp, kernels, builds):
    """Each build of ``builds`` ({label: [(pattern, replacement)]}) as a copy
    of csrc with the rewrites applied, rows 3 and 4's sources compiled from
    it, all at once; stops when a rewrite matches nothing. Returns {label:
    {source: .so path}}."""
    procs, out = [], {}
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
        for name in ROWS:
            so = os.path.join(d, f"lib{name}.so")
            out.setdefault(label, {})[name] = so
            procs.append((label, subprocess.Popen(
                [kernels._nvcc(), *kernels._NVCC_FLAGS, "-o", so,
                 os.path.join(d, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for label, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {label}:\n{log[-3000:]}")
    return out


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


def _hash(x):
    import torch

    bits = x.contiguous().view(
        torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:16]


def _cases():
    """(dtype name, row, fn) for rows 3 and 4 at (7040, 20) in both
    dtypes, on the inputs of scripts/qkv_bwd_ab.py."""
    import torch

    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from scripts.qkv_bwd_ab import _inputs

    for dtype in ("bfloat16", "float32"):
        qkv, bias, g, _ = _inputs(7040, 20, getattr(torch, dtype), False, 5)
        _, probs = fa.qkv_fwd_probs(qkv, bias, None, 20)
        yield dtype, "row3", (lambda q=qkv, b=bias, p=probs, gg=g:
                              fa.qkv_bwd_probs(q, b, p, gg, 20))
        yield dtype, "row4", (lambda q=qkv, b=bias, gg=g:
                              fa.qkv_bwd(q, b, None, gg, 20))


def parts():
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(list(ROWS))
    with tempfile.TemporaryDirectory(prefix="qkv_bwd_variants_") as tmp:
        sos = build_variants(tmp, kernels, {"base": [], **PARTS})
        for dtype, row, fn in _cases():
            for label, libs in sos.items():
                for name, so in libs.items():
                    kernels._libs[name] = load(so, name)
                print("PART " + json.dumps({"build": label, "row": row,
                                            "dtype": dtype,
                                            "ms": cs.time_ms(fn, 20)}),
                      flush=True)


def _forced(fa, heads, nbuf, threads=None, per_sm=2):
    """bwd_launch_plan with the resident plan at (heads, nbuf) (and
    ``threads`` a block, ``per_sm`` blocks an SM), its shared bytes
    resident_smem's."""
    import torch

    own = fa.bwd_launch_plan

    def plan(n, t, h, d, dtype, sms=132, probs=False):
        p = own(n, t, h, d, dtype, sms, probs)
        r = p.resident
        itemsize = 2 if dtype == torch.bfloat16 else 4
        items = n * -(-h // heads)
        return p._replace(resident=r._replace(
            heads=heads, nbuf=nbuf, items=items,
            blocks=min(items, per_sm * sms), threads=threads or r.threads,
            smem=fa.resident_smem(t, d, itemsize, heads, nbuf, probs)))
    return plan


def plans():
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    own = fa.bwd_launch_plan
    for dtype, row, fn in _cases():
        for heads in (1, 2, 3, 4, 5):
            for nbuf in (1, 2):
                itemsize = 2 if dtype == "bfloat16" else 4
                if fa.resident_smem(20, 20, itemsize, heads, nbuf,
                                    row == "row3") > kernels.MAX_SMEM:
                    continue
                fa.bwd_launch_plan = _forced(fa, heads, nbuf)
                try:
                    print("PLAN " + json.dumps({
                        "row": row, "dtype": dtype, "heads": heads,
                        "nbuf": nbuf, "hash": _hash(fn()),
                        "ms": cs.time_ms(fn, 20)}), flush=True)
                finally:
                    fa.bwd_launch_plan = own


def shape():
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(list(ROWS))
    own = fa.bwd_launch_plan
    with tempfile.TemporaryDirectory(prefix="qkv_bwd_variants_") as tmp:
        sos = build_variants(tmp, kernels, SHAPES)
        for dtype, row, fn in _cases():
            for label, libs in sos.items():
                for name, so in libs.items():
                    kernels._libs[name] = load(so, name)
                for nbuf in (1, 2):
                    fa.bwd_launch_plan = _forced(fa, 4, nbuf,
                                                 per_sm=int(label[1:]))
                    try:
                        print("SHAPE " + json.dumps({
                            "build": label, "nbuf": nbuf, "row": row,
                            "dtype": dtype, "hash": _hash(fn()),
                            "ms": cs.time_ms(fn, 20)}), flush=True)
                    finally:
                        fa.bwd_launch_plan = own


def batch():
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(list(ROWS))
    with tempfile.TemporaryDirectory(prefix="qkv_bwd_variants_") as tmp:
        sos = build_variants(tmp, kernels, {"rb5": [], **BATCHES})
        for dtype, row, fn in _cases():
            for label, libs in sos.items():
                for name, so in libs.items():
                    kernels._libs[name] = load(so, name)
                print("BATCH " + json.dumps({
                    "build": label, "row": row, "dtype": dtype,
                    "hash": _hash(fn()), "ms": cs.time_ms(fn, 20)}),
                    flush=True)


def main() -> int:
    import torch

    modes = {"parts": parts, "plans": plans, "shape": shape, "batch": batch}
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
