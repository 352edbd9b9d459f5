from reference.nn.posenc import posenc, posenc_dim
from reference.nn.resnet import ResNetTrunk
from reference.nn.resnetfc import ResnetFC
from reference.nn.spatial_encoder import SpatialEncoder
from reference.nn.vgg import Vgg19Features

__all__ = ["ResNetTrunk", "ResnetFC", "SpatialEncoder", "Vgg19Features",
           "posenc", "posenc_dim"]
