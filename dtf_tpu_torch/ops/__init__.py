"""Ops of the port: attention and its Hopper kernel."""
