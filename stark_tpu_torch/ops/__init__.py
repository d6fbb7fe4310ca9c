"""Device-side building blocks of the torch prover.

Field elements live on the device as ``(8, *batch)`` ``int32`` tensors of
16-bit Montgomery limbs (:mod:`stark_tpu_torch.ops.limbs`).  Each module
that wraps a CUDA kernel (``cuda_ntt``, ``cuda_merkle``, ``cuda_fold``,
``cuda_fs``) has its plain PyTorch version beside it; the plain version
runs for CPU tensors only.
"""
