"""Ops of the port: attention, the LM losses and the embedding gather, each
kernel beside its plain PyTorch version."""
