"""Process-level flags, read once at import.

* ``MX_HARDWARE_EXACT_QUANTIZATION`` — ``"True"`` selects the integer
  hw-exact quantizer for the plain (CPU) path, ``"False"`` (default) the
  simulated fp32-divide one.  Both are bit-identical by contract; the CUDA
  kernel implements the hw-exact pipeline.
"""

import os

MX_EXACT_QUANTIZATION = os.environ.get("MX_HARDWARE_EXACT_QUANTIZATION", "False")
