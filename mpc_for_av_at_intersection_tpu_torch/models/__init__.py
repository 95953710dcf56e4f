from .vehicle import VehicleGeometry, bicycle_geometry, prius_geometry

__all__ = ["VehicleGeometry", "bicycle_geometry", "prius_geometry"]
