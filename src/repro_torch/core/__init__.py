"""The paper's pruning, the packed format, and the packed-model runner."""
