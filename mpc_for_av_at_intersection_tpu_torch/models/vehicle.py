"""Vehicle geometry: wheelbase + circle-based collision approximation.

A copy of ``mpc_for_av_at_intersection_tpu/models/vehicle.py`` (numpy
only), so that the port and ``chip_smoke.py`` load nothing of the JAX
package; ``tests/test_torch_port_imports.py`` pins it to the original.

Capability parity with the reference ``main/lib/car_dimensions.py``:
a rear-axle-anchored vehicle approximated by one or two collision circles
(radius = width / sqrt(2)) placed along the heading axis, as a plain frozen
dataclass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VehicleGeometry:
    """Static geometric description of a vehicle, anchored at the rear axle.

    ``circle_centers`` are offsets (in the vehicle frame, x = heading) of the
    collision-circle centers from the rear-axle anchor; cf. the two-circle
    approximation of reference ``main/lib/car_dimensions.py:67-79``.
    """

    name: str
    wheelbase: float          # rear-to-front wheel distance (bicycle-model L)
    width: float              # bounding-box width
    length: float             # bounding-box length
    single_circle: bool = False  # skip the rear circle (cheaper, coarser)

    @property
    def center_offset(self) -> Tuple[float, float]:
        # rear axle -> geometric center (along heading)
        return (self.wheelbase / 2.0, 0.0)

    @property
    def radius(self) -> float:
        return self.width / math.sqrt(2.0)

    @property
    def circle_centers(self) -> np.ndarray:
        """(n_circles, 2) circle-center offsets in the vehicle frame."""
        spread = self.length / 2.0 - self.width / 2.0
        cx, cy = self.center_offset
        if self.single_circle:
            return np.array([[cx + spread, cy]], dtype=np.float64)
        return np.array(
            [[cx + spread, cy], [cx - spread, cy]], dtype=np.float64
        )

    @property
    def n_circles(self) -> int:
        return 1 if self.single_circle else 2


def bicycle_geometry(single_circle: bool = False) -> VehicleGeometry:
    """The generic bicycle-model car (reference ``car_dimensions.py:82-90``)."""
    return VehicleGeometry(
        name="bicycle_model",
        wheelbase=2.86,
        width=2.0,
        length=2.86 + 0.64,
        single_circle=single_circle,
    )


def prius_geometry(
    scaling_factor: float = 1.0, single_circle: bool = False
) -> VehicleGeometry:
    """Toyota Prius dimensions (reference ``car_dimensions.py:93-107``)."""
    return VehicleGeometry(
        name="prius",
        wheelbase=4.0 * scaling_factor,
        width=2.04 * scaling_factor,
        length=4.84 * scaling_factor,
        single_circle=single_circle,
    )
