from jyutvoice_tpu_torch.pipeline.server import ServingEngine  # noqa: F401
