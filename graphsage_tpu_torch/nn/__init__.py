"""Layers as plain functions on tensors: initializers, dense, the mean,
gcn and pooling aggregators and the on-device neighbor sampler."""
