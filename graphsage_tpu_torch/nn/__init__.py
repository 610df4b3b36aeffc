"""Layers as plain functions on tensors: initializers, dense, the
mean/gcn aggregators and the on-device neighbor sampler."""
