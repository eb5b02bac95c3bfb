from repro_torch.checkpoint import store

__all__ = ["store"]
