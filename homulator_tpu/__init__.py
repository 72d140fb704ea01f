"""homulator_tpu: an RNS-CKKS ciphertext-operation framework in JAX.

Implements, for real on an NVIDIA GPU (H100), the datapaths that the reference
Homulator simulator (FHE-ACCELE/Homulator) models cycle-accurately:
NTT/iNTT, elementwise modular arithmetic, base conversion, automorphism,
hybrid key switching, rescale — exposed as the operation set
hmult / hadd / hrotate / pmult / padd.
"""

from .params import CkksParams, get_params

__version__ = "0.1.0"
