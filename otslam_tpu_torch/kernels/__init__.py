"""Compute kernels: TSDF fusion (dense and block-sparse), resampling,
nearest-neighbour search, ICP, tracking, the pose graph, ray casting, scan
differencing and evidence grids. Modules holding a hand-written CUDA kernel
keep its plain PyTorch version beside the wrapper (tsdf_cuda.py: K1 fusion
and K2 classification; nn.py: K3 and K4 nearest neighbour; raycast.py: K5
ray cast)."""
