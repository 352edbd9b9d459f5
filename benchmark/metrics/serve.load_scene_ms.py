"""Mean host-clock ms of the window's RenderServer.load_scene calls, each
ended by a device synchronize (the encoder, the normals, the int8 quad
latent's packing)."""


def read(ctx):
    spans = ctx["spans"].get("load_scene")
    return 1e3 * sum(spans) / len(spans) if spans else None
