"""PyTorch/CUDA port of newsrecommendation_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout module for module and imports none of it.
The current slice is NRMS serving: corpus news-vector cache, user encoding
and scoring, corpus top-k and the micro-batching HTTP server, with the
fused-qkv exp-MHSA forward as a CUDA kernel (ops/fused_attention.py).
Entry points run on ``device="cuda"`` unless told ``device="cpu"``.
"""
