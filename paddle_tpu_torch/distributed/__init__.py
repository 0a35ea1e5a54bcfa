"""Distributed helpers of the port (counterpart of paddle_tpu/distributed):
for now ``fleet.utils.recompute``, which single-device training uses."""
