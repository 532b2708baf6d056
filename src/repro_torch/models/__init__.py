"""Model zoo: the 10 assigned architectures as one composable trunk, the
port of the JAX package's ``models`` (forward, loss, its backward under
block remat, and decode; the shard_map MoE dispatch and the tensor-parallel
layouts come in a later slice).

Every arch is a configuration of the same decoder trunk (``trunk.py``) —
mixer pattern (attention / local attention / Mamba / RG-LRU) x feed-forward
type (dense SwiGLU/GeGLU/GELU or MoE) — except whisper, which composes the
same layers into an encoder-decoder (``encdec.py``).  ``model.py`` holds the
``Model`` module, ``convert.py`` carries the reference's weights across.
"""

from repro_torch.models.config import ARCHS, ArchConfig, get_config
from repro_torch.models.model import Model

import repro_torch.configs  # noqa: E402,F401  (registers the 10 arch configs)

__all__ = ["ARCHS", "ArchConfig", "get_config", "Model"]
