from diner_tpu_torch.nn.posenc import posenc, posenc_dim
from diner_tpu_torch.nn.resnet import ResNetTrunk
from diner_tpu_torch.nn.resnetfc import ResnetFC
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoder

__all__ = ["ResNetTrunk", "ResnetFC", "SpatialEncoder", "posenc",
           "posenc_dim"]
