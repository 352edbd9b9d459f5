from diner_tpu_torch.nn.posenc import posenc, posenc_dim
from diner_tpu_torch.nn.resnet import ResNetTrunk
from diner_tpu_torch.nn.resnetfc import ResnetFC
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoder
from diner_tpu_torch.nn.vgg import Vgg19Features

__all__ = ["ResNetTrunk", "ResnetFC", "SpatialEncoder", "Vgg19Features",
           "posenc", "posenc_dim"]
