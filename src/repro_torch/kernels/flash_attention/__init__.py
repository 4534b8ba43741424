"""Blocked online-softmax attention (FlashAttention-style)."""
