from visreps_tpu_torch.runners.base_runner import ExperimentRunner, load_param_grid

__all__ = ["ExperimentRunner", "load_param_grid"]
