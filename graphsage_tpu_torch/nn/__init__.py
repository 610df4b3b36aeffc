"""Layers as plain functions on tensors: initializers, dense, the mean,
gcn, pooling and seq aggregators, the on-device neighbor sampler, the
edge-prediction losses and unigram negative sampling."""
