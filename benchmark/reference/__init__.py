"""The benchmark's plain reference: a frozen copy of diner_tpu_torch's plain
PyTorch paths (the encoder, the depth-guided sampler, the field, the
renderer, the losses), with every kernel replaced by its plain version and
no import of the port. Later changes to the port cannot move it."""
