"""Auxiliary subsystems: checkpointing."""
