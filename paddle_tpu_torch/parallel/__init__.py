"""Parallelism (≙ paddle_tpu/parallel), trimmed to the 2-D block
quantization the weight-only serving path uses (collective.py)."""
