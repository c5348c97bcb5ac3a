"""PyTorch + CUDA port of the ARGUS reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference and is not imported here:
this package imports ``torch`` and numpy only, and keeps its own copy
of every stdlib-only module it needs.  Its layout mirrors ``repro`` so
each module's counterpart is found under the same name.

Slice 1 is the kernel path of paged serving for dense GQA decoders:

    serve.PagedServingEngine(decode_path="kernel", prefill_path="kernel")
      -> models.transformer.TransformerLM.prefill_chunk_packed /
         decode_step_paged
      -> kernels.ragged_prefill  (CUDA, csrc/ragged_prefill.cu)
         kernels.paged_attention (CUDA, csrc/paged_decode.cu)

Slice 2 is the paper's own workflow on the GEMM family:

    core.harness.optimize_kernel (planner, selector, lowering agent)
      -> core.harness.Validator(run_kernels=True)
      -> core.verify_engine.VerificationEngine (the ARGUS gate, with the
         Hopper structural model core.kernelspec and the H100 cost
         model core.costs)
      -> core.families.gemm.reference_check -> kernels.gemm.matmul
      -> kernels.gemm (CUDA, csrc/gemm.cu)

Slice 3 is the paper's second family, flash attention, on the same
workflow, and the gate on the serving path:

    core.harness.optimize_kernel -> Validator(run_kernels=True)
      -> core.families.flash_attention / flash_decode .reference_check
      -> kernels.flash_attention.mha / mha_decode (the gate, then)
      -> kernels.flash_attention (CUDA, csrc/flash_attention.cu and
         csrc/flash_decode.cu)
    serve.PagedServingEngine -> the paged_attention and ragged_prefill
      families, verified once per batch / packed geometry

Entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present, unless ``device="cpu"`` is passed; on CPU
tensors each kernel wrapper runs its plain PyTorch version.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
