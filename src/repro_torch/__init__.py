"""PyTorch + CUDA port of the ARGUS reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference and is not imported here:
this package imports ``torch`` and numpy only, and keeps its own copy
of every stdlib-only module it needs.  Its layout mirrors ``repro`` so
each module's counterpart is found under the same name.

Slice 1 (this package today) is the kernel path of paged serving for
dense GQA decoders:

    serve.PagedServingEngine(decode_path="kernel", prefill_path="kernel")
      -> models.transformer.TransformerLM.prefill_chunk_packed /
         decode_step_paged
      -> kernels.ragged_prefill  (CUDA, csrc/ragged_prefill.cu)
         kernels.paged_attention (CUDA, csrc/paged_decode.cu)

Entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present, unless ``device="cpu"`` is passed; on CPU
tensors each kernel wrapper runs its plain PyTorch version.  The
symbolic ARGUS gate of the JAX package (``VerificationEngine``) is not
ported yet; the concrete runtime checks of the serving path are.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
