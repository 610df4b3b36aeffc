"""Sample-and-aggregate orchestration: the GraphSAGE pyramid, the
supervised head and the unsupervised towers."""
