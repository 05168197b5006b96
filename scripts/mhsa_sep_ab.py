#!/usr/bin/env python3
"""One side of an A/B of the separate-q/k/v attention (rows 5-8) on one
NVIDIA GPU: run it from the root of each checkout in turn, in one process
per run, on the same card (parent, change, change, parent) and compare the
lines it prints.

    python3 scripts/mhsa_sep_ab.py LABEL

It prints one line, ``AB {json}``: for rows 5 and 7 (mhsa_sep_fwd) and
rows 6 and 8 (mhsa_sep_bwd) at every shape of chip_smoke.py's kernel-sep
phase ((7040, 20) with d_v = 20 and 32, (128, 300) and (64, 511) with
d_v = 32; 20 heads, d_k = 20; f32 and bf16, unmasked and key-masked, on
q, k, v cut from one projection as the smoke cuts them), a hash of the
output on fixed inputs, so two checkouts can be held equal bit for bit,
its ms (CUDA events, chip_smoke.time_ms over 10 calls) and its launches
per regime (empty where the checkout counts none). It uses the checkout's
own package and chip_smoke.py, so it runs on older checkouts too. Without
CUDA it exits 1.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.getcwd())

SHAPES = ((7040, 20, 20), (7040, 20, 32), (128, 300, 32), (64, 511, 32))
HEADS, DK = 20, 20


def _hash(xs):
    import torch

    h = hashlib.sha256()
    for x in xs:
        bits = x.contiguous().view(
            torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
        h.update(bits.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _inputs(n, t, dv, dtype, masked, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    hdk, hdv = HEADS * DK, HEADS * dv
    proj = torch.randn((n, t, 2 * hdk + hdv), generator=gen,
                       device="cuda").to(dtype)
    q, k, v = torch.split(proj, [hdk, hdk, hdv], dim=-1)
    g = torch.randn((n, t, hdv), generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = (torch.rand((n, t), generator=gen, device="cuda") > 0.3).float()
        mask[:, -1] = 1.0
        mask[::7] = 0.0
    return q, k, v, g, mask


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as cs
    from newsrecommendation_tpu_torch.ops import fused_attention as fa
    from newsrecommendation_tpu_torch.ops import kernels

    kernels.build(["mhsa_sep"])
    out = {"label": sys.argv[1], "card": torch.cuda.get_device_name(0)}
    for n, t, dv in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for masked in (False, True):
                q, k, v, g, mask = _inputs(n, t, dv, dtype, masked, 5)
                name = (f"{str(dtype).split('.')[1]} {n}x{t} dv{dv}"
                        f"{' masked' if masked else ''}")
                kernels.reset_launch_counts()
                with torch.inference_mode():
                    fwd = _hash([fa.mhsa_sep_fwd(q, k, v, mask, HEADS)])
                    bwd = _hash(fa.mhsa_sep_bwd(q, k, v, mask, g, HEADS))
                out[f"fwd {name}"] = [fwd, cs.time_ms(
                    lambda: fa.mhsa_sep_fwd(q, k, v, mask, HEADS), 10),
                    kernels.regime_counts("mhsa_fwd")]
                out[f"bwd {name}"] = [bwd, cs.time_ms(
                    lambda: fa.mhsa_sep_bwd(q, k, v, mask, g, HEADS), 10),
                    kernels.regime_counts("mhsa_bwd")]
                print(f"  {name}: fwd {out[f'fwd {name}']} bwd "
                      f"{out[f'bwd {name}']}", flush=True)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
