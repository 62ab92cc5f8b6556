# Launch drivers of the port: python -m repro_torch.launch.serve
__all__ = ["serve"]
