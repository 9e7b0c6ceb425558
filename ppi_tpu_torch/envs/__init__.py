"""Environments on the scalar physics program (door-v0)."""
