"""The fused OBIA model (the port's counterpart of ``obia_tpu/models``):
SLIC, object features and an MLP head in one forward pass, and its
sharded training step."""
