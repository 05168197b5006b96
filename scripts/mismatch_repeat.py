#!/usr/bin/env python3
"""Repeats the two f32 card-against-CPU comparisons that each failed once
(rows 5-8 behind the model's projection, chip_smoke.py's
``mhsa-unequal masked=False``; rows 15-16 behind it,
``test_blanes_layout_launches_rows_15_16[False]``) many times on one
NVIDIA GPU, to tell a fault of the kernels from one of the projection.

    python3 scripts/mismatch_repeat.py [REPS] [OUT_DIR]
                                       [--poison[=VALUE]] [--after-smoke]

Each case computes its CPU reference once, then runs the card side REPS
times (default 2000) from the same parameters and input. With --poison,
before each repeat 1 GiB of the allocator's cache is filled with NaN (or
VALUE) and freed again, so a kernel that reads memory it never wrote (a
scratch slot, a pad) sees it there and fails the comparison; a finite
VALUE also reaches reads whose NaN a max or a comparison would drop. Per repeat it
checks whether the card's output and input gradient equal the first
repeat's bit for bit, counts the elements outside the tolerance the
original check used, and compares the projection's output alone (q, k,
v) with the CPU's. With OUT_DIR the inputs of the first failing repeat
are saved there (give a git-ignored directory). With --after-smoke the
process first runs chip_smoke.py's phases that come before
``mhsa-unequal`` (every kernel case, chip_smoke.kernel_phases) and then
the two ``mhsa-unequal`` phases themselves (chip_smoke.unequal_run,
recording whether each passed), as the smoke's own process does, then
the loops. It prints one line,
``MISMATCH {json}``: per case the repeats, the failing ones, the repeats
whose bits differ from the first, the largest error of the output and of
the projection, and the card. Exits 1 without CUDA.

    python3 scripts/mismatch_repeat.py --fresh=N[:P]

runs chip_smoke.unequal_run (both masks, in the smoke's order) once in
each of N new processes, P at a time (default 4), since a failure has
only been seen as the first run of its process: it prints
``FRESH {json}``, the processes that failed with their diagnoses, the
CPU reference votes that took a third run (chip_smoke.cpu_reference),
the distinct ctx errors of those that passed, and the range of each
diagnosis number over all of them.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())


def _project(p, x):
    """The q, k, v projections as multi_head_self_attention computes them."""
    return [x @ p[k]["w"] + p[k]["b"] for k in ("wq", "wk", "wv")]


def _case(name, params, x, mask, g, heads, layout, io, reps, out_dir,
          tol, poison):
    import numpy as np
    import torch

    from newsrecommendation_tpu_torch.ops import attention, kernel_config

    def run(dev):
        p = {k: {n: w.detach().to(dev).requires_grad_()
                 for n, w in v.items()} for k, v in params.items()}
        xx = x.detach().to(dev).requires_grad_()
        out = attention.multi_head_self_attention(
            p, xx, None if mask is None else mask.to(dev), n_heads=heads)
        out.backward(g.to(dev))
        with torch.no_grad():
            proj = _project(p, xx.detach())
        return out.detach(), xx.grad, proj

    kernel_config.set_attention_layout(layout)
    kernel_config.set_attention_io(io)
    try:
        out_c, dx_c, proj_c = run("cpu")
        ref = (out_c.cuda(), dx_c.cuda(), [y.cuda() for y in proj_c])
        first, changed, failing, worst, worst_proj = None, 0, [], 0.0, 0.0
        for rep in range(reps):
            if poison is not None:  # freed at once: the next
                # allocations reuse it
                torch.full((256 << 20,), poison, device="cuda")
            out, dx, proj = run("cuda")
            if first is None:
                first = (out, dx)
            elif not (torch.equal(out, first[0])
                      and torch.equal(dx, first[1])):
                changed += 1
            err = (out - ref[0]).abs()
            bad = int((err > tol[0][1] + tol[0][0] * ref[0].abs()).sum())
            bad += int(((dx - ref[1]).abs()
                        > tol[1][1] + tol[1][0] * ref[1].abs()).sum())
            worst = max(worst, err.max().item())
            pe = max((a - b).abs().max().item()
                     for a, b in zip(proj, ref[2]))
            worst_proj = max(worst_proj, pe)
            if bad:
                failing.append({"rep": rep, "outside": bad,
                                "max_err": err.max().item(),
                                "proj_max_err": pe})
                if len(failing) == 1 and out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    np.savez(os.path.join(out_dir, f"{name}.npz"),
                             x=x.numpy(), g=g.numpy(),
                             mask=np.zeros(0) if mask is None
                             else mask.numpy(), out=out.cpu().numpy(),
                             ref=ref[0].cpu().numpy(), **{
                                 f"{k}_{n}": w.numpy()
                                 for k, v in params.items()
                                 for n, w in v.items()})
    finally:
        kernel_config.set_attention_layout("headloop")
        kernel_config.set_attention_io("3d")
    return {"reps": reps, "failing": failing[:10], "n_failing": len(failing),
            "n_bits_changed": changed, "max_err": worst,
            "proj_max_err": worst_proj}


def _child() -> dict:
    """One process's chip_smoke.unequal_run for each mask, in order."""
    import torch

    import chip_smoke as cs

    out = {}
    for masked in (False, True):
        try:
            r = cs.unequal_run(masked)
            out[str(masked)] = {"passed": True,
                                "ctx_err": r["ctx"]["max_abs_err"],
                                "dx_err": r["dx"]["max_abs_err"],
                                "diagnosis": r["diagnosis"],
                                "cpu_reference": r["cpu_reference"]}
        except RuntimeError as e:
            out[str(masked)] = {"passed": False, "error": str(e)}
    out["card"] = torch.cuda.get_device_name(0)
    return out


def _fresh(spec: str) -> dict:
    """--fresh=N[:P]: _child in N new processes, P at a time."""
    import subprocess

    from newsrecommendation_tpu_torch.ops import kernels

    n, _, p = spec.partition(":")
    n, p = int(n), int(p or 4)
    kernels.build(["mhsa_sep"])  # the children load it
    cmd = [sys.executable, os.path.abspath(__file__), "--child"]
    runs, todo, live = [], list(range(n)), []
    t0 = time.perf_counter()
    while todo or live:
        while todo and len(live) < p:
            todo.pop()
            live.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True))
        proc = live.pop(0)
        stdout, stderr = proc.communicate()
        line = next((ln for ln in stdout.splitlines()
                     if ln.startswith("CHILD ")), None)
        runs.append(json.loads(line[6:]) if line else
                    {"rc": proc.returncode, "stderr": stderr[-2000:]})
    failed = [r for r in runs if any(
        not r.get(m, {}).get("passed", False) for m in ("False", "True"))]
    spans = {}
    for r in runs:
        for m in ("False", "True"):
            for key, val in r.get(m, {}).get("diagnosis", {}).items():
                if isinstance(val, (int, float)) and not isinstance(val,
                                                                    bool):
                    lo, hi = spans.get(f"{m}:{key}", (val, val))
                    spans[f"{m}:{key}"] = (min(lo, val), max(hi, val))
    votes = [r[m]["cpu_reference"] for r in runs for m in ("False", "True")
             if r.get(m, {}).get("passed")
             and r[m]["cpu_reference"]["runs"] > 2]
    return {"processes": n, "parallel": p,
            "seconds": time.perf_counter() - t0, "n_failed": len(failed),
            "failed": failed, "cpu_votes": votes,
            "ctx_errs": sorted({r[m]["ctx_err"] for r in runs
                                for m in ("False", "True")
                                if r.get(m, {}).get("passed")}),
            "host": next((r[m]["diagnosis"]["host"] for r in runs
                          for m in ("False", "True")
                          if r.get(m, {}).get("passed")), None),
            "spans": spans}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    if "--child" in sys.argv:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("CHILD " + json.dumps(_child()), flush=True)
        return 0
    fresh = next((a.partition("=")[2] for a in sys.argv[1:]
                  if a.startswith("--fresh")), None)
    if fresh:
        print("FRESH " + json.dumps(_fresh(fresh)), flush=True)
        return 0
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    poison = next((float(a.partition("=")[2] or "nan")
                   for a in sys.argv[1:] if a.startswith("--poison")), None)
    after_smoke = "--after-smoke" in sys.argv
    reps = int(args[0]) if args else 2000
    out_dir = args[1] if len(args) > 1 else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from newsrecommendation_tpu_torch.ops import attention, kernels

    res = {"card": torch.cuda.get_device_name(0), "poison": poison,
           "after_smoke": after_smoke}
    if after_smoke:
        import chip_smoke as cs
        from newsrecommendation_tpu_torch.ops import blockwise as bw
        from newsrecommendation_tpu_torch.ops import experimental_blanes as bl
        from newsrecommendation_tpu_torch.ops import (
            experimental_fused_encoder as fe,
        )
        from newsrecommendation_tpu_torch.ops import experimental_qkv2d as q2
        from newsrecommendation_tpu_torch.ops import fused_attention as fa

        kernels.build()
        t0 = time.perf_counter()
        cases = cs.kernel_phases(fa, bw, bl, fe, q2)
        res["smoke_phases_s"] = time.perf_counter() - t0
        res["smoke_cases"] = sum(len(c) for c in cases.values())
        # then the smoke's own mhsa-unequal phases (a mismatch prints
        # chip_smoke.unequal_diagnosis's line first)
        for masked in (False, True):
            try:
                cs.unequal_run(masked)
                res[f"smoke_unequal_masked_{masked}"] = "passed"
            except RuntimeError as e:
                res[f"smoke_unequal_masked_{masked}"] = str(e)
    else:
        kernels.build(["mhsa_sep", "blanes"])
    # chip_smoke.unequal_run(False): rows 5-8 at d_v != d_k
    gen = torch.Generator().manual_seed(800)
    params = attention.init_multi_head_self_attention(gen, 300, 20, 20, 32)
    x = torch.randn((1024, 20, 300), generator=gen)
    g = torch.randn((1024, 20, 20 * 32), generator=gen)
    res["mhsa_unequal"] = _case("mhsa_unequal", params, x, None, g, 20,
                                "headloop", "3d", reps, out_dir,
                                ((1e-5, 1e-5), (1e-4, 1e-4)), poison)
    # test_blanes_layout_launches_rows_15_16[False]
    rng = np.random.default_rng(3)
    params = {k: {"w": torch.from_numpy(rng.normal(scale=0.3, size=(
                      32, 32)).astype(np.float32)),
                  "b": torch.from_numpy(rng.normal(scale=0.1, size=(
                      32,)).astype(np.float32))}
              for k in ("wq", "wk", "wv")}
    x = torch.from_numpy(rng.normal(size=(40, 20, 32)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(40, 20, 32)).astype(np.float32))
    res["blanes"] = _case("blanes", params, x, None, g, 4, "blanes", "2d",
                          reps, out_dir, ((1e-5, 1e-5), (1e-4, 1e-4)),
                          poison)
    print("MISMATCH " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
