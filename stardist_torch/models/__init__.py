"""The models and their registry of pretrained models (counterpart of
``stardist_tpu/models/__init__.py``).

``register_model(cls, key, source, hash)`` names a pretrained model: a
local model folder, or a URL of a zip of one (checked against its md5 and
unpacked into the cache, ``$STARDIST_TORCH_MODEL_CACHE`` or
``~/.cache/stardist_torch/models``). ``StarDist2D.from_pretrained(name)``
loads it by its key or an alias. The registry holds upstream StarDist's
zoo (the reference's URLs, md5s and aliases; their weights are Keras HDF5
files, read by ``StarDistBase._import_keras_h5``) and the demo models of
``models/examples``.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import urllib.request
import zipfile
from pathlib import Path

from .model2d import Config2D, StarDist2D
from .model3d import Config3D, StarDist3D

__all__ = ["Config2D", "Config3D", "StarDist2D", "StarDist3D", "clear_models_and_aliases",
           "get_model_details", "get_registered_models", "register_aliases", "register_model"]

_MODELS = {}
_ALIASES = {}


def register_model(cls, key, path_or_url, hash=None):
    """Register a pretrained model of ``cls``: a model folder, or the URL of
    a zip of one with its md5 ``hash``."""
    _MODELS.setdefault(cls.__name__, {})[key] = dict(source=path_or_url, hash=hash)


def register_aliases(cls, key, *names):
    for name in names:
        _ALIASES.setdefault(cls.__name__, {})[name] = key


def clear_models_and_aliases(*cls_list):
    """Forget the registered models and aliases of ``cls_list`` (all when
    none is given)."""
    if len(cls_list) == 0:
        _MODELS.clear()
        _ALIASES.clear()
    for cls in cls_list:
        _MODELS.pop(cls.__name__, None)
        _ALIASES.pop(cls.__name__, None)


def get_registered_models(cls, verbose=False):
    """(models, aliases) registered for ``cls``: key -> details and alias
    -> key."""
    models = _MODELS.get(cls.__name__, {})
    aliases = _ALIASES.get(cls.__name__, {})
    if verbose:
        print(f"Registered models for '{cls.__name__}':")
        for k in models:
            names = [a for a, v in aliases.items() if v == k]
            print(f"  {k}" + (f" (aliases: {', '.join(names)})" if names else ""))
    return models, aliases


def get_model_details(cls, key_or_alias, verbose=False):
    """(key, details) of a registered model of ``cls``."""
    models, aliases = get_registered_models(cls)
    key = aliases.get(key_or_alias, key_or_alias)
    if key not in models:
        raise ValueError(f"'{key_or_alias}' is not a registered model for '{cls.__name__}'")
    if verbose:
        print(f"Found model '{key}' for '{cls.__name__}'.")
    return key, models[key]


def _cache_dir():
    return Path(os.environ.get("STARDIST_TORCH_MODEL_CACHE",
                               Path.home() / ".cache" / "stardist_torch" / "models"))


def _fetch_model_zip(cls, key, url, md5=None):
    """The model folder of a zip at ``url`` (http, https or file): fetched
    once into the cache, checked against ``md5``, unpacked (a folder nested
    one level down is moved up)."""
    target = _cache_dir() / cls.__name__ / key
    if (target / "config.json").exists():
        return target
    target.mkdir(parents=True, exist_ok=True)
    zip_path = target / "model.zip"
    with urllib.request.urlopen(url) as r, open(zip_path, "wb") as f:
        shutil.copyfileobj(r, f)
    if md5 is not None:
        got = hashlib.md5(zip_path.read_bytes()).hexdigest()
        if got != md5:
            zip_path.unlink()
            raise ValueError(f"md5 mismatch for {url}: got {got}, expected {md5}")
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(target)
    zip_path.unlink()
    if not (target / "config.json").exists():
        subdirs = [d for d in target.iterdir() if d.is_dir() and (d / "config.json").exists()]
        if len(subdirs) == 1:
            for item in subdirs[0].iterdir():
                shutil.move(str(item), str(target / item.name))
            subdirs[0].rmdir()
    if not (target / "config.json").exists():
        raise ValueError(f"downloaded archive for '{key}' contains no config.json")
    return target


def _from_pretrained(cls, name_or_alias=None, *, device="cuda"):
    """The registered model ``name_or_alias`` of ``cls`` on ``device`` (the
    card unless the caller passes ``device="cpu"``); without a name, print
    the registered models and return None."""
    if name_or_alias is None:
        get_registered_models(cls, verbose=True)
        return None
    key, details = get_model_details(cls, name_or_alias)
    source = str(details["source"])
    if "://" in source:
        folder = _fetch_model_zip(cls, key, source, md5=details.get("hash"))
    elif Path(source).is_dir():
        folder = Path(source)
    else:
        raise ValueError(f"pretrained model source '{source}' is neither a local directory "
                         "nor a URL")
    return cls(None, name=folder.name, basedir=str(folder.parent), device=device)


StarDist2D.from_pretrained = classmethod(_from_pretrained)
StarDist3D.from_pretrained = classmethod(_from_pretrained)

_ZOO = "https://github.com/stardist/stardist-models/releases/download/v0.1"
for _key, _md5, _alias in (
        ("2D_versatile_fluo", "8db40dacb5a1311b8d2c447ad934fb8a", "Versatile (fluorescent nuclei)"),
        ("2D_versatile_he", "bf34cb3c0e5b3435971e18d66778a4ec", "Versatile (H&E nuclei)"),
        ("2D_paper_dsb2018", "6287bf283f85c058ec3e7094b41039b5",
         "DSB 2018 (from StarDist 2D paper)")):
    register_model(StarDist2D, _key, f"{_ZOO}/python_{_key}.zip", _md5)
    register_aliases(StarDist2D, _key, _alias)

_EXAMPLES = Path(__file__).resolve().parents[2] / "models" / "examples"
for _cls, _key, _alias in ((StarDist2D, "2D_demo", "Demo 2D"), (StarDist3D, "3D_demo", "Demo 3D")):
    if (_EXAMPLES / _key).is_dir():
        register_model(_cls, _key, str(_EXAMPLES / _key))
        register_aliases(_cls, _key, _alias)
del _key, _md5, _alias, _cls
