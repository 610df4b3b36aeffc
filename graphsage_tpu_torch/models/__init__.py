"""Sample-and-aggregate orchestration: the GraphSAGE pyramid and the
supervised head."""
