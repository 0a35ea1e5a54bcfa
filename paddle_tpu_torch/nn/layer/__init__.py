"""The port's Paddle-signature layers (counterpart of paddle_tpu/nn/layer):
the ones the encoder path builds on."""
