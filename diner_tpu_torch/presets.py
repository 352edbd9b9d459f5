"""The fast DTU render preset as the port's constructor arguments.

Mirrors configs/evaluate_diner_on_dtu_fast.yaml as the JAX package's
bench.py builds it (the PixelNeRF defaults supply backbone resnet34 and
encoder_layers 4). The YAML config registry itself is not ported yet.
"""

FAST_DTU_MODEL = dict(
    backbone="resnet34", encoder_layers=4, encoder_norm="batch",
    image_padding=64, padding_pe=4, num_freqs=6, freq_factor=6.28,
    n_blocks=5, d_hidden=512, combine_layer=3, compute_dtype="bfloat16",
    quad_latent=True, latent_quant="int8", sigma_activation="relu")

FAST_DTU_RENDER = dict(
    n_samples=32, n_depth_candidates=1000, n_gaussian=15, white_bkgd=False,
    n_prior_anchors=256, paired_prior_gather=True, eval_chunk_rays=4096)

# the DTU evaluation image size and source-view count the preset serves
FAST_DTU_IMAGE = (256, 320)
FAST_DTU_VIEWS = 4
