"""Process-level flags, read once at import.  Code reads them as attributes
of this module at call time, so a test or a script may set them.

* ``MX_HARDWARE_EXACT_QUANTIZATION`` — ``"True"`` selects the integer
  hw-exact quantizer for the plain (CPU) path, ``"False"`` (default) the
  simulated fp32-divide one.  Both are bit-identical by contract; the CUDA
  kernel implements the hw-exact pipeline.
* ``TORCHMX_KV_LAYOUT`` — storage layout of an MX KV cache built by
  ``MXLayerKVCache.create`` without an explicit ``layout``: ``"seq"``
  (default; codes ``(b, kv, L, d)``) or ``"dmajor"`` (codes ``(b, kv, d, L)``,
  the sequence on the last, contiguous axis; the layout that takes fp4
  caches).
* ``TORCHMX_ATTN_INT8_DOT`` — ``"1"``: decode attention (one query position)
  over an int8 d-major cache runs all in int8: q is MXINT8-quantized per
  32-block and the softmax weights are requantized to 8 bits per (chunk,
  row, KV tile).  Changes numerics slightly; default ``"0"``.
"""

import os

MX_EXACT_QUANTIZATION = os.environ.get("MX_HARDWARE_EXACT_QUANTIZATION", "False")

TORCHMX_KV_LAYOUT = os.environ.get("TORCHMX_KV_LAYOUT", "seq")

TORCHMX_ATTN_INT8_DOT = os.environ.get("TORCHMX_ATTN_INT8_DOT", "0")
