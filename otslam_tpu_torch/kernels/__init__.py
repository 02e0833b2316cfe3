"""Compute kernels: TSDF fusion (dense and block-sparse), resampling and
nearest-neighbour search. Modules holding a hand-written CUDA kernel keep
its plain PyTorch version beside the wrapper (tsdf_cuda.py: K1 fusion and
K2 classification; nn.py: K3 nearest neighbour)."""
