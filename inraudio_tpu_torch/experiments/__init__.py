from .runner import (build_arch, build_problem, make_experiment_folder,
                     train, train_from_signal)

__all__ = ["build_arch", "build_problem", "make_experiment_folder", "train",
           "train_from_signal"]
