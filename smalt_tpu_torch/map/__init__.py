from .engine import MapEngine, MapParams
