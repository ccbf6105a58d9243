"""Leveled CKKS over the torus: twin of `poulpy_tpu/ckks/` (layouts, the
host encoder, the leveled operations with rotations and conjugation, and the
plaintext forms of `plaintext.py`).

Ciphertexts are GLWEs with a `CKKSMeta{log_delta, log_budget}` bit-level
scale and capacity tracker; rescaling is a pure limb bit-shift.
"""

from poulpy_tpu_torch.ckks.encoder import Encoder  # noqa: F401
from poulpy_tpu_torch.ckks.layouts import CKKSCiphertext, CKKSMeta, CKKSPlaintext  # noqa: F401
