"""dropoutdecoding_tpu_torch: the PyTorch + CUDA port of dropoutdecoding_tpu
for NVIDIA Hopper (H100).

The JAX package beside it is the reference; every module here mirrors one
of its modules and is held against it by ``tests/test_torch_*.py``.  Plain
tensor code is PyTorch; each TPU kernel on the ported path is a CUDA C++
kernel under ``csrc/`` (built by ``ops/_build.py``), with a plain-torch
twin that the wrappers use for CPU tensors.

Layout:
  ops/       norms, RoPE, attention, uncertainty; kernel wrappers and build
  models/    CLIP ViT, projector, Llama decoder, LLaVA and LLaVA-NeXT
             compositions
  decoding/  dropout-mask policies, vote / average aggregation
  engine/    LlavaEngine: prefill, exact ensemble / greedy decode loop;
             LlavaNextEngine: its anyres prefill
  parallel/  the ("data", "model") mesh over torch.distributed ranks, the
             shard functions, and the collectives tensor parallelism issues
  utils/     config dataclasses, PRNG key tree, weight conversion
  csrc/      CUDA sources (sm_90a)
"""

__version__ = "0.1.0"
