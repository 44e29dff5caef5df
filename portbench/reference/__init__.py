"""The plain reference of the model: float32 PyTorch over the parameter
trees of `portbench/layout.py`, at batch 1 and each request's own length,
with no kernel, cache or batching. It imports nothing of the program and
nothing of JAX; `frontend` turns the traffic's text into token ids again."""
