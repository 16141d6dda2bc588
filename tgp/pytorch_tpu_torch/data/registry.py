"""Dataset registry: name -> data loaders + data_config, the port's copy of
the JAX package's `data/registry.py::return_dataset`: the UCI regression
and classification tables and the large corpora (`large.py`: airline,
year, rainfall, and the partition corpora air_quality and
rainfall_spatial, which take their split from `options`).
"""

from __future__ import annotations

from .batching import ArrayDataset, DataLoader
from .large import LARGE_LOADERS
from .uci import UCI_TABLE, load_uci_split
from .uci_classification import CLASSIFICATION_LOADERS, NUM_CLASSES

UCI_REGRESSION = [n for n, s in UCI_TABLE.items() if s.task == "regression"]
UCI_CLASSIFICATION = list(CLASSIFICATION_LOADERS)


def return_dataset(name: str, batch_size: int, use_validation=None,
                   seed: int = 1, options: dict | None = None):
    """Build [train(, valid), test] DataLoaders and a data_config dict
    (X_tr, Y_tr, N_tr, Dx, Dy, Y_std, Y_mean, task) for a named dataset.
    A classification dataset's Dy is its number of classes, its Y the
    labels (JAX `data/registry.py:12-71`).

    options keys honoured: 'shuffle_train' (default True), 'generator_seed'
    for the training loader's generator (default 0), 'normalize_y'; for
    air_quality and rainfall_spatial, whose `seed` selects the fold or
    partition, their split options (`large.py`).  A table that is not under
    the data root raises FileNotFoundError naming it.
    """
    options = dict(options or {})
    shuffle_train = bool(options.get("shuffle_train", True))
    gen_seed = options.get("generator_seed", 0)
    is_classification = False
    if name in UCI_TABLE:
        split = load_uci_split(name, seed, use_validation,
                               normalize_y=options.get("normalize_y", True))
    elif name in CLASSIFICATION_LOADERS:
        split = CLASSIFICATION_LOADERS[name](seed, use_validation)
        is_classification = True
    elif name in ("airline", "year", "rainfall"):
        split = LARGE_LOADERS[name](seed, use_validation)
    elif name in ("air_quality", "rainfall_spatial"):
        split = LARGE_LOADERS[name](seed, use_validation, options=options)
    else:
        raise NotImplementedError(
            f"dataset {name!r} not available (add a loader to "
            "data/registry.py)")

    loaders = [DataLoader(ArrayDataset(split["X_tr"], split["Y_tr"]),
                          batch_size, shuffle=shuffle_train, seed=gen_seed)]
    if split["X_va"] is not None:
        loaders.append(DataLoader(ArrayDataset(split["X_va"], split["Y_va"]),
                                  batch_size, shuffle=False))
    loaders.append(DataLoader(ArrayDataset(split["X_te"], split["Y_te"]),
                              batch_size, shuffle=False))

    data_config = {
        "X_tr": split["X_tr"],
        "Y_tr": split["Y_tr"],
        "N_tr": split["X_tr"].shape[0],
        "Dx": split["X_tr"].shape[1],
        "Dy": NUM_CLASSES[name] if is_classification else split["Y_tr"].shape[1],
        "Y_std": split["Y_std"],
        "Y_mean": split["Y_mean"],
        "task": "classification" if is_classification else "regression",
    }
    return loaders, data_config
