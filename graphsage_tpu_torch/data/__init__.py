"""Host-side data layer: dataset contract, padded adjacency, batchers,
random walks, fixtures.

NumPy only; the arrays it builds are moved to the device once.
"""
