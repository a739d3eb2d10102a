from .pipelines import band_split_train, procedural_train
from .runner import (build_arch, build_problem, make_experiment_folder,
                     train, train_from_signal)

__all__ = ["band_split_train", "build_arch", "build_problem",
           "make_experiment_folder", "procedural_train", "train",
           "train_from_signal"]
