"""Distributed NE in PyTorch, with its round kernels in CUDA for Hopper.

The port of the JAX package ``repro``, package by package; see
``repro_torch.core.partitioner`` for the single-controller partitioner.
"""
