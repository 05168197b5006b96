"""PyTorch/CUDA port of newsrecommendation_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module and imports none of it.
Ported so far: NRMS serving (corpus news-vector cache, user encoding and
scoring, corpus top-k, the micro-batching HTTP server) and NRMS training
(train/: create_train_state, make_train_step / make_multi_step, fit over
TrainSamples from a prepared behaviors shard). The fused-qkv exp-MHSA
forward, its probs-saving variant and its backward are CUDA kernels
(ops/fused_attention.py). Entry points run on ``device="cuda"`` unless
told ``device="cpu"``.
"""
