from .flash_attention import tile_stats

__all__ = ["tile_stats"]
