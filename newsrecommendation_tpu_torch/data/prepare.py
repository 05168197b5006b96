"""Offline behaviors.tsv preparation: negative sampling and shard
splitting for training, shard splitting for testing.

Per impression: split the clicked and non-clicked news, drop impressions
lacking either, emit one line per positive with npratio sampled negatives
(sampling from a replicated pool when negatives are scarce), shuffle all
lines once, and split them round-robin into behaviors_np{K}_{shard}.tsv.
The same seed gives files byte-identical to the JAX package's
(newsrecommendation_tpu/data/prepare.py), so either side reads the other's.
For testing, the raw behaviors.tsv lines are split round-robin into
behaviors_{shard}.tsv.
Each shard is written to a process-unique temp name and renamed into
place, so a concurrent reader only ever sees a complete file.
"""

from __future__ import annotations

import logging
import os
import random
from typing import List


def sample_negatives(negatives: List[str], k: int,
                     rng: random.Random) -> List[str]:
    """k negatives without replacement, replicating the pool if too small."""
    if k > len(negatives):
        pool = negatives * (k // len(negatives) + 1)
        return rng.sample(pool, k)
    return rng.sample(negatives, k)


def prepare_training_data(train_data_dir: str, num_shards: int, npratio: int,
                          seed: int) -> int:
    """Write the training shards beside {train_data_dir}/behaviors.tsv;
    returns the number of samples (lines) written over all shards."""
    rng = random.Random(seed)
    out_lines: List[str] = []
    path = os.path.join(train_data_dir, "behaviors.tsv")
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            iid, uid, time, history, imp = line.rstrip("\n").split("\t")
            pos, neg = [], []
            for item in imp.split(" "):
                news_id, _, label = item.partition("-")
                if label == "1":
                    pos.append(news_id)
                elif label == "0":
                    neg.append(news_id)
            if not pos or not neg:
                continue
            for pos_id in pos:
                negs = " ".join(sample_negatives(neg, npratio, rng))
                out_lines.append(
                    "\t".join([iid, uid, time, history, pos_id, negs]) + "\n")

    rng.shuffle(out_lines)
    for shard in range(num_shards):
        shard_path = os.path.join(train_data_dir,
                                  f"behaviors_np{npratio}_{shard}.tsv")
        _atomic_write_lines(shard_path, out_lines[shard::num_shards])
    logging.info("prepared %d training samples into %d shards",
                 len(out_lines), num_shards)
    return len(out_lines)


def _atomic_write_lines(path: str, lines: List[str]) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.writelines(lines)
    os.replace(tmp, path)


def prepare_testing_data(test_data_dir: str, num_shards: int) -> int:
    """Split {test_data_dir}/behaviors.tsv round-robin into
    behaviors_{shard}.tsv; returns the number of lines."""
    path = os.path.join(test_data_dir, "behaviors.tsv")
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    for shard in range(num_shards):
        shard_path = os.path.join(test_data_dir, f"behaviors_{shard}.tsv")
        _atomic_write_lines(shard_path, lines[shard::num_shards])
    logging.info("prepared %d testing samples into %d shards",
                 len(lines), num_shards)
    return len(lines)
