"""Flight-path rendering on the host (the port of
ble_tpu/env/rendering/renderer.py; reference env/rendering/renderer.py:26-62
and matplotlib_renderer.py:35-207).

A Renderer ABC and a matplotlib renderer that draws the 3-D flight path,
the battery's state of charge and a top-down inset with the
station-keeping radius. The renderer records one balloon's track: step()
takes the port's batch-first EnvState of one env (the gym env's) and
copies its four values to the host at once; add_point() takes a point
already on the host (the training loop's env-0 track). matplotlib is
imported only when an image is drawn.
"""

import abc
from typing import Optional, Sequence

import numpy as np
import torch

from ble_tpu_torch.env import balloon as balloon_lib


class Renderer(abc.ABC):
  """Render lifecycle (reference renderer.py:26-62)."""

  @abc.abstractmethod
  def reset(self) -> None:
    ...

  @abc.abstractmethod
  def step(self, env_state) -> None:
    ...

  @abc.abstractmethod
  def render(self, mode: str):
    ...

  @property
  @abc.abstractmethod
  def render_modes(self) -> Sequence[str]:
    ...


class MatplotlibRenderer(Renderer):
  """3-D path + power + top-down inset (matplotlib_renderer.py:35-207)."""

  def __init__(self, station_keeping_radius_km: float = 50.0):
    self._radius_km = station_keeping_radius_km
    self.reset()

  def reset(self) -> None:
    self._xs, self._ys, self._pressures, self._socs = [], [], [], []

  def step(self, env_state) -> None:
    """Records the balloon of an EnvState holding one env: x and y in km,
    pressure and the state of charge over the battery's capacity."""
    b = env_state.balloon
    if b.x_m.shape != (1,):
      raise ValueError('MatplotlibRenderer.step takes the state of one env, '
                       f'got x_m of shape {tuple(b.x_m.shape)}')
    x, y, pressure, charge = torch.stack(
        [b.x_m[0], b.y_m[0], b.pressure_pa[0], b.battery_charge_j[0]]).tolist()
    self.add_point(x / 1000.0, y / 1000.0, pressure,
                   charge / balloon_lib.BalloonParams.battery_capacity_j)

  def add_point(self, x_km: float, y_km: float, pressure_pa: float,
                soc: float) -> None:
    """Appends one track point already on the host (the training loop
    streams env 0's track this way)."""
    self._xs.append(x_km)
    self._ys.append(y_km)
    self._pressures.append(pressure_pa)
    self._socs.append(soc)

  @property
  def render_modes(self) -> Sequence[str]:
    # 'tensorboard' mirrors the reference's summary-image mode
    # (matplotlib_renderer.py:109-121): a (1, H, W, 3) float batch in
    # [0, 1] ready for a summary writer's image() call.
    return ['human', 'rgb_array', 'tensorboard']

  def render(self, mode: str = 'human') -> Optional[np.ndarray]:
    if mode not in self.render_modes:
      raise ValueError(f'Unsupported render mode {mode}')
    import matplotlib
    if mode != 'human':
      matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(10, 5))
    ax3d = fig.add_subplot(1, 2, 1, projection='3d')
    # Altitude proxy: negated pressure so up means up.
    ax3d.plot(self._xs, self._ys, [-p for p in self._pressures])
    ax3d.set_xlabel('x [km]')
    ax3d.set_ylabel('y [km]')
    ax3d.set_zlabel('-pressure [Pa]')

    ax2d = fig.add_subplot(2, 2, 2)
    ax2d.plot(self._xs, self._ys, lw=0.8)
    theta = np.linspace(0, 2 * np.pi, 100)
    ax2d.plot(self._radius_km * np.cos(theta),
              self._radius_km * np.sin(theta), 'r--', lw=0.8)
    ax2d.set_aspect('equal')
    ax2d.set_xlabel('x [km]')
    ax2d.set_ylabel('y [km]')

    ax_p = fig.add_subplot(2, 2, 4)
    ax_p.plot(self._socs)
    ax_p.set_ylim(0, 1)
    ax_p.set_xlabel('step')
    ax_p.set_ylabel('battery soc')
    fig.tight_layout()

    if mode == 'human':
      plt.show()
      plt.close(fig)
      return None
    fig.canvas.draw()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    image = buf.reshape(h, w, 4)[:, :, :3].copy()
    plt.close(fig)
    if mode == 'tensorboard':
      return image[np.newaxis].astype(np.float32) / 255.0
    return image
