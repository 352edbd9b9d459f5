from diner_tpu_torch.models.diner import DINER
from diner_tpu_torch.models.from_jax import from_jax
from diner_tpu_torch.models.lightning import (from_lightning,
                                              load_torch_state_dict,
                                              to_lightning)
from diner_tpu_torch.models.pixelnerf import (PixelNeRF, index_depth_std,
                                              index_normal)

__all__ = ["DINER", "PixelNeRF", "from_jax", "from_lightning",
           "index_depth_std", "index_normal", "load_torch_state_dict",
           "to_lightning"]
