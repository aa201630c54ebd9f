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

The weight-layout and dispatch knobs of the MX linear, with the JAX
package's names and defaults (``torchmx_tpu/env_variables.py``).  A layout
knob is read once, when ``MXInferenceLinear`` is built; ``TORCHMX_FP8_DOT``
also at every call of ``mx_dynamic_matmul``:

* ``TORCHMX_FP6_PACK`` — ``"1"`` (default): fp6 weights with
  ``K % 1024 == 0`` are stored in the planar "quarters" layout (4 codes per
  3 bytes, read by B8); ``"0"`` keeps one byte per code (B6).
* ``TORCHMX_FP8_HALVES`` — ``"1"`` (default): fp8 weights with
  ``K % 512 == 0`` and every scale ``>= 10`` are stored in the u16 "halves"
  layout (word p holds codes p and p + K/2, read by K3); ``"0"`` keeps the
  flat layout (B6).
* ``TORCHMX_FP8_DOT`` — ``"1"``: fp8 activations with flat fp8 weights at
  ``M <= 256`` go through B9's fp8 variant (e4m3 codes into the tensor
  cores, per-block rescale); the layout stays flat.  Default ``"0"``.
* ``TORCHMX_INT8_DOMAIN`` — ``"1"``: fp4 and fp6 e2m3 weights are re-coded
  exactly as MXINT8 (``MXTensor.to_int8_domain``), so int8 activations take
  B9 at decode sizes.  Default ``"0"``.
"""

import os

MX_EXACT_QUANTIZATION = os.environ.get("MX_HARDWARE_EXACT_QUANTIZATION", "False")

TORCHMX_KV_LAYOUT = os.environ.get("TORCHMX_KV_LAYOUT", "seq")

TORCHMX_ATTN_INT8_DOT = os.environ.get("TORCHMX_ATTN_INT8_DOT", "0")

TORCHMX_FP6_PACK = os.environ.get("TORCHMX_FP6_PACK", "1")

TORCHMX_FP8_HALVES = os.environ.get("TORCHMX_FP8_HALVES", "1")

TORCHMX_FP8_DOT = os.environ.get("TORCHMX_FP8_DOT", "0")

TORCHMX_INT8_DOMAIN = os.environ.get("TORCHMX_INT8_DOMAIN", "0")
