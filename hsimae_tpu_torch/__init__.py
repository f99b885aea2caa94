"""PyTorch + CUDA port of ``hsimae_tpu`` for one NVIDIA H100 (sm_90a).

Module names and public function names follow the JAX package, so each
module's counterpart is found under the same path in ``hsimae_tpu``. This
package imports torch and numpy only: never jax, flax, optax or anything of
``hsimae_tpu``.

Numerics policy, set here once for the whole package: float32 matrix
products and convolutions run in full float32 on the card (no TF32), so an
f32 run can be held against the JAX reference and the hand-written kernel's
plain version at f32 tolerances.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
