"""Serialization: pickle, YAML (numpy-aware), and self-describing HDF5 pytrees.

Parity: reference `montecosmo/utils.py:76-185` (psave/pload, ysave/yload,
h5save/h5load, h5save_tree/h5load_tree).  Register files, sampler states and
per-run sample dumps all go through these.
"""
import pickle

import numpy as np


# ----------------------------------------------------------------------------- pickle
def psave(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def pload(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# ----------------------------------------------------------------------------- yaml
def _yaml():
    """PyYAML, imported on first use so that `import montecosmo_tpu` does not
    need it; numpy arrays and scalars dump as plain lists and numbers."""
    import yaml

    yaml.SafeDumper.add_representer(
        np.ndarray, lambda dumper, data: dumper.represent_list(data.tolist()))
    yaml.SafeDumper.add_multi_representer(
        np.generic, lambda dumper, data: dumper.represent_data(data.item()))
    return yaml


def ysave(obj, path):
    with open(path, "w") as f:
        _yaml().safe_dump(obj, f)


def yload(path):
    with open(path, "r") as f:
        return _yaml().safe_load(f)


def to_np(x):
    """Device array -> numpy."""
    return np.asarray(x)


# ----------------------------------------------------------------------------- hdf5
def h5save(path, data: dict):
    """Save a (possibly nested) dict to HDF5.

    None values are skipped (signalling 'absent' to the loader), nested dicts
    become groups, everything else (arrays, scalars, strings, bools) becomes a
    dataset.  Used for self-describing register files and sample dumps.
    """
    import h5py

    def write(grp, d):
        for k, v in d.items():
            if v is None:
                continue
            if isinstance(v, dict):
                write(grp.create_group(k), v)
            elif isinstance(v, (str, bytes, bool, int, float)):
                grp[k] = v
            else:
                arr = to_np(v)
                if arr.dtype.kind == "U":  # h5py has no unicode-array path
                    arr = arr.astype("S")
                grp[k] = arr

    with h5py.File(str(path), "w") as f:
        write(f, data)


def h5load(path):
    """Load an HDF5 file written by `h5save` into a nested dict.

    Groups become sub-dicts, byte strings are decoded, 0-d scalars become
    native python values (clean yaml/repr round trips).
    """
    import h5py

    def read(grp):
        out = {}
        for k, item in grp.items():
            if isinstance(item, h5py.Group):
                out[k] = read(item)
            else:
                v = item[()]
                if isinstance(v, bytes):
                    v = v.decode()
                elif isinstance(v, np.ndarray) and v.dtype.kind in ("S", "O"):
                    v = [x.decode() if isinstance(x, bytes) else x for x in v]
                elif isinstance(v, np.generic):
                    v = v.item()
                out[k] = v
        return out

    with h5py.File(str(path), "r") as f:
        return read(f)


def h5save_tree(path, tree):
    """Save a pytree of arrays (e.g. a sampler state or tuned config) to HDF5.

    NamedTuples and dicts become nested groups, leaves become arrays.  Reload
    with `h5load_tree`, passing the NamedTuple class to rebuild it.
    """
    def to_dict(x):
        if hasattr(x, "_asdict"):  # NamedTuple (sampler states / adaptation configs)
            return {k: to_dict(v) for k, v in x._asdict().items()}
        if isinstance(x, dict):
            return {k: to_dict(v) for k, v in x.items()}
        return to_np(x)

    h5save(path, to_dict(tree))


def h5load_tree(path, cls=None):
    """Load a pytree saved by `h5save_tree`.

    If `cls` is a NamedTuple type, rebuild it from the top-level fields (nested
    dicts, e.g. `position`, stay dicts); else return the raw dict.
    """
    d = h5load(path)
    return d if cls is None else cls(**d)
