#!/usr/bin/env python3
"""The command line's train_test on one NVIDIA GPU with each behaviors
parser in turn: the pure-Python one (what the port ran before it had the
native one) and the native one (csrc/mindio.cpp), in the order python,
native, native, python after one warm-up run that is not counted.

    python3 scripts/parse_ab.py      # from the repo root, on a machine
                                     # with one CUDA card, nvcc and g++

Each run is chip_smoke's ``cli`` train_test: NRMS at its published width
on chip_smoke.cli_corpus (4,000 news, one epoch of 3k+1 steps of B = 128
in bf16, a save every k steps, then phase 2 over the dev impressions), in
a fresh model directory. Each run's line gives its parser, the wall
seconds of cli.main, and the seconds and rows of each behaviors parse as
the loader logged them. The last line is ``AB {json}`` with the card's
name and power limit. Without CUDA it exits 1.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ORDER = ("native", "python", "native", "native", "python")  # first: warm-up


class ParseLog(logging.Handler):
    """Collects the loader's one line per parse: (path, rows, parser,
    seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.parses = []

    def emit(self, record):
        if " parser in " in record.getMessage():
            path, rows, parser, secs = record.args
            self.parses.append({"file": os.path.basename(path), "rows": rows,
                                "parser": parser, "s": secs})


def main() -> int:
    import torch

    import chip_smoke
    from newsrecommendation_tpu_torch import cli
    from newsrecommendation_tpu_torch.data import native_loader

    if not torch.cuda.is_available():
        print("parse_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not native_loader.available():
        print("parse_ab: the native parser did not build", file=sys.stderr)
        return 1
    log = ParseLog()
    logging.getLogger().addHandler(log)
    logging.getLogger().setLevel(logging.INFO)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, dev_dir, steps = chip_smoke.cli_corpus(tmp)
        for i, parser in enumerate(ORDER):
            argv = ["--mode", "train_test", "--train_data_dir", train_dir,
                    "--test_data_dir", dev_dir, "--model_dir",
                    os.path.join(tmp, f"model{i}"), "--user_log_mask",
                    "True", "--compute_dtype", "bfloat16", "--batch_size",
                    "128", "--save_steps", str((steps - 1) // 3), "--lr",
                    "3e-4", "--log_steps", "10"] + chip_smoke.ONE_CARD
            # no library: the loader takes its Python parser
            off = (mock.patch.object(native_loader, "_load",
                                     return_value=None)
                   if parser == "python" else contextlib.nullcontext())
            log.parses.clear()
            native_loader.reset_parser_counts()
            with off:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cli.main(argv, device="cuda")
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            counts = native_loader.parser_counts()
            if counts[parser] != 2 or sum(counts.values()) != 2:
                print(f"parse_ab: run {i} meant {parser}, parsed {counts}",
                      file=sys.stderr)
                return 1
            run = {"run": i, "parser": parser, "warmup": i == 0,
                   "train_test_s": secs, "parses": list(log.parses)}
            print(json.dumps(run), flush=True)
            runs.append(run)
    timed = [r for r in runs if not r["warmup"]]
    print("AB " + json.dumps({
        "card": card, "steps": steps,
        **{f"{p}_train_test_s": [r["train_test_s"] for r in timed
                                 if r["parser"] == p]
           for p in ("python", "native")},
        **{f"{p}_parse_s": [sum(x["s"] for x in r["parses"]) for r in timed
                            if r["parser"] == p]
           for p in ("python", "native")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
