"""x265amod-tpu-torch: the PyTorch/CUDA port of the x265amod_tpu HEVC
encoder for one NVIDIA H100.

This slice encodes BASELINE config 1 (all-intra CTU32, CQP, deblock on,
SAO/AQ off, sign-bit hiding) with four hand-written CUDA kernels
(`csrc/`): intra prediction + SATD, the residual chain, TU bit estimation
and the deblocking filter.  Entry point:
`x265amod_tpu_torch.models.encoder.Encoder(param, device="cuda")`.
A CPU tensor takes each kernel's plain PyTorch version (the tests do so).
The package imports neither jax nor the JAX package.
"""
