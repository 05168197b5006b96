"""PyTorch/CUDA port of newsrecommendation_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module and imports none of it.
Ported so far: NRMS and NAML (models/), both title formats, serving
(corpus news-vector cache, user encoding and scoring, corpus top-k, the
micro-batching HTTP server with /reload), training (train/:
create_train_state, make_train_step / make_multi_step, fit over
TrainSamples from a prepared behaviors shard), two-phase evaluation,
checkpoints and the command line (cli.py), data parallelism and
row-sharded tables over ranks (parallel/). Every attention kernel of the
JAX package is a CUDA kernel (csrc/, ops/); NAML runs none of them.
Entry points run on ``device="cuda"`` unless told ``device="cpu"``.
"""
