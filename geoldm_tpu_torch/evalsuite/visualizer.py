"""Molecule rendering: xyz text files, 3D pictures, chain GIFs (port of
``geoldm_tpu/evalsuite/visualizer.py``; reference qm9/visualizer.py).

Host code on numpy arrays, built on the port's own ``bond_analyze``: xyz
save/load (reference :18-56), matplotlib 3D renders with bonds inferred from
the distance tables (:97-230), a directory of molecules to PNGs (:233-259)
and chain GIFs through imageio (:325-393). The file formats and the pictures
are JAX's. matplotlib and imageio are imported inside the functions that
draw, so the xyz writer and reader need neither; ``require_renderer`` lets a
CLI refuse a rendering flag at argument checking on a host without them.
"""

from __future__ import annotations

import glob
import importlib.util
import os
import random
from typing import List, Optional, Tuple

import numpy as np

from geoldm_tpu_torch.evalsuite import bond_analyze as ba

RENDER_PACKAGES = ("matplotlib", "imageio")


def missing_renderer_packages() -> List[str]:
    """Those of matplotlib and imageio this interpreter cannot import."""
    return [name for name in RENDER_PACKAGES if importlib.util.find_spec(name) is None]


def require_renderer(flag: str) -> None:
    """Exit naming the missing package(s) when ``flag`` asks for pictures on
    a host without matplotlib or imageio (the xyz files need neither)."""
    missing = missing_renderer_packages()
    if missing:
        raise SystemExit(f"{flag} renders with matplotlib and imageio; this Python lacks "
                         f"{' and '.join(missing)}")


def save_xyz_file(path: str, one_hot: np.ndarray, charges: Optional[np.ndarray],
                  positions: np.ndarray, dataset_info, id_from: int = 0,
                  name: str = "molecule", node_mask: Optional[np.ndarray] = None) -> List[str]:
    """One xyz-style .txt per molecule, 'N\\n\\n' then 'El x y z' lines
    (reference qm9/visualizer.py:18-38) -> the file names."""
    os.makedirs(path, exist_ok=True)
    one_hot, positions = np.asarray(one_hot), np.asarray(positions)
    if node_mask is not None:
        atomsxmol = np.asarray(node_mask).reshape(len(one_hot), -1).sum(axis=1)
    else:
        atomsxmol = [one_hot.shape[1]] * one_hot.shape[0]
    decoder = dataset_info["atom_decoder"]
    files = []
    for i in range(one_hot.shape[0]):
        fname = os.path.join(path, f"{name}_{i + id_from:03d}.txt")
        n = int(atomsxmol[i])
        types = np.argmax(one_hot[i], axis=1)
        with open(fname, "w") as f:
            f.write(f"{n}\n\n")
            for a in range(n):
                x, y, z = positions[i, a]
                f.write(f"{decoder[int(types[a])]} {x:.9f} {y:.9f} {z:.9f}\n")
        files.append(fname)
    return files


def load_molecule_xyz(file: str, dataset_info) -> Tuple[np.ndarray, np.ndarray]:
    """-> (positions [n, 3], one_hot [n, S]) (reference qm9/visualizer.py:41-56)."""
    encoder = dataset_info["atom_encoder"]
    s = len(dataset_info["atom_decoder"])
    with open(file, encoding="utf8") as f:
        n = int(f.readline())
        f.readline()
        positions = np.zeros((n, 3), dtype=np.float32)
        one_hot = np.zeros((n, s), dtype=np.float32)
        for i in range(n):
            parts = f.readline().split()
            one_hot[i, encoder[parts[0]]] = 1.0
            positions[i] = [float(v) for v in parts[1:4]]
    return positions, one_hot


def load_xyz_files(path: str, shuffle: bool = True) -> List[str]:
    """The .txt files of a directory, shuffled with Python's ``random`` as
    JAX's are."""
    files = glob.glob(os.path.join(path, "*.txt"))
    if shuffle:
        random.shuffle(files)
    return files


def plot_molecule_3d(ax, positions: np.ndarray, atom_types: np.ndarray, dataset_info,
                     alpha: float = 1.0, bg_color: str = "white") -> None:
    """Atoms as spheres and the inferred bonds as lines on a 3D axis."""
    colors = np.array(dataset_info["colors_dic"])
    radii = np.array(dataset_info["radius_dic"])
    areas = 1500 * radii[atom_types] ** 2
    ax.scatter(positions[:, 0], positions[:, 1], positions[:, 2], s=areas,
               c=[colors[t] for t in atom_types], alpha=0.9 * alpha, edgecolors="#333333",
               linewidths=0.5)
    orders = ba.pairwise_bond_orders(positions.astype(np.float64), atom_types,
                                     tuple(dataset_info["atom_decoder"]))
    if dataset_info["name"] == "geom":
        orders = np.minimum(orders, 1)
    line_color = "#666666" if bg_color == "white" else "#bbbbbb"
    for i in range(len(positions)):
        for j in range(i):
            if orders[i, j] > 0:
                p, q = positions[i], positions[j]
                ax.plot([p[0], q[0]], [p[1], q[1]], [p[2], q[2]],
                        linewidth=0.5 + 1.5 * orders[i, j], c=line_color, alpha=alpha)


def _axis_limit(max_value: float) -> float:
    return min(40.0, max(max_value / 1.5 + 0.3, 3.2))


def _figure(bg: str, elev: float, azim: float):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.set_axis_off()
    ax.view_init(elev=elev, azim=azim)
    fig.patch.set_facecolor(bg)
    ax.set_facecolor(bg)
    return plt, fig, ax


def _limits(ax, lim: float) -> None:
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)


def plot_data3d(positions: np.ndarray, atom_types: np.ndarray, dataset_info,
                save_path: Optional[str] = None, camera_elev: float = 10,
                camera_azim: float = -60, bg: str = "white", alpha: float = 1.0):
    """Render one molecule to ``save_path`` (100 dpi PNG), or return the
    figure (reference qm9/visualizer.py:156-230)."""
    plt, fig, ax = _figure(bg, camera_elev, camera_azim)
    plot_molecule_3d(ax, positions, atom_types, dataset_info, alpha=alpha, bg_color=bg)
    _limits(ax, _axis_limit(max(float(np.abs(positions).max()), 1e-3)))
    if save_path is not None:
        plt.savefig(save_path, bbox_inches="tight", pad_inches=0.0, dpi=100)
        plt.close(fig)
        return None
    return fig


def visualize(path: str, dataset_info, max_num: int = 25, spheres_3d: bool = False) -> List[str]:
    """Render up to ``max_num`` xyz files of a directory to PNGs beside them
    (reference qm9/visualizer.py:233-259) -> the PNG names."""
    out = []
    for file in load_xyz_files(path)[:max_num]:
        positions, one_hot = load_molecule_xyz(file, dataset_info)
        png = file.replace(".txt", ".png")
        plot_data3d(positions, np.argmax(one_hot, axis=1), dataset_info, save_path=png)
        out.append(png)
    return out


def _gif(files: List[str], pngs: List[str], gif_name: str) -> str:
    import imageio

    gif_path = os.path.join(os.path.dirname(files[0]), f"{gif_name}.gif")
    imageio.mimsave(gif_path, [imageio.v2.imread(p) for p in pngs], subrectangles=True)
    return gif_path


def visualize_chain(path: str, dataset_info, spheres_3d: bool = False,
                    gif_name: str = "output") -> Optional[str]:
    """A chain directory's frames (sorted xyz files) as an animated GIF
    (reference qm9/visualizer.py:325-351) -> its path, None without frames."""
    files = sorted(load_xyz_files(path, shuffle=False))
    if not files:
        return None
    pngs = []
    for file in files:
        positions, one_hot = load_molecule_xyz(file, dataset_info)
        png = file.replace(".txt", ".png")
        plot_data3d(positions, np.argmax(one_hot, axis=1), dataset_info, save_path=png)
        pngs.append(png)
    return _gif(files, pngs, gif_name)


def visualize_chain_uncertainty(path: str, dataset_info, spheres_3d: bool = False,
                                gif_name: str = "output", alpha: float = 0.5) -> Optional[str]:
    """A chain as a GIF whose every frame overlays three consecutive states
    at partial alpha, so per-step variance shows as ghosting (reference
    qm9/visualizer.py:354-393); fewer than three frames: ``visualize_chain``."""
    files = sorted(load_xyz_files(path, shuffle=False))
    if len(files) < 3:
        return visualize_chain(path, dataset_info, spheres_3d, gif_name)
    pngs = []
    for i in range(len(files) - 2):
        plt, fig, ax = _figure("white", 10, -60)
        max_value = 1e-3
        for f in files[i:i + 3]:
            positions, one_hot = load_molecule_xyz(f, dataset_info)
            plot_molecule_3d(ax, positions, np.argmax(one_hot, axis=1), dataset_info,
                             alpha=alpha)
            max_value = max(max_value, float(np.abs(positions).max()))
        _limits(ax, _axis_limit(max_value))
        png = files[i].replace(".txt", ".png")
        plt.savefig(png, bbox_inches="tight", pad_inches=0.0, dpi=100)
        plt.close(fig)
        pngs.append(png)
    return _gif(files, pngs, gif_name)


def save_chain(path: str, chain_one_hot: np.ndarray, chain_charges: np.ndarray,
               chain_x: np.ndarray, dataset_info) -> None:
    """Chain frames as numbered xyz files (``chain_000.txt`` ...) for
    ``visualize_chain``."""
    for i in range(len(chain_x)):
        save_xyz_file(path, chain_one_hot[i:i + 1], chain_charges[i:i + 1], chain_x[i:i + 1],
                      dataset_info, id_from=i, name="chain")
