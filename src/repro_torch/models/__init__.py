"""Decoder-only LM (dense path)."""
