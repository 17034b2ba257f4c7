"""Launcher helpers of the port."""
