from .ckpt import async_save, latest_step, restore, save

__all__ = ["save", "restore", "latest_step", "async_save"]
