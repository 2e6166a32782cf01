"""The training engine's frame (counterpart of
``vince_tpu/solvers/base_solver.py``): the constructor runs
``setup_dataloader → setup_other → setup_model → setup_optimizer``; the
learning rate follows the schedule by global step (the step writes it into
the optimizer; ``adjust_learning_rate`` computes it for the log); meters are
reset each epoch; crash saves are the runner's.
"""

import abc
from typing import Dict, Optional

import numpy as np

from vince_tpu_torch.utils.logger import Logger
from vince_tpu_torch.utils.meters import RollingAverageMeter
from vince_tpu_torch.utils.schedules import vince_lr_schedule

TIME_KEYS = ("total_time", "data_cache_time", "step_time", "metrics_time", "log_save_time")


class BaseSolver(abc.ABC):
    def __init__(self, args, train_logger: Optional[Logger] = None,
                 val_logger: Optional[Logger] = None):
        self.args = args
        self.input_size = args.input_size
        self.logger_iteration = 0
        self.train_logger = None if args.debug else train_logger
        self.val_logger = None if args.debug else val_logger
        self.time_meters: Dict[str, RollingAverageMeter] = {}
        self.metric_meters: Dict[str, RollingAverageMeter] = {}
        self.loss_meters: Dict[str, RollingAverageMeter] = {}
        self.iteration = 0  # counts samples: += batch_size per step
        self.epoch = 0
        self.lr_schedule = vince_lr_schedule(
            args.base_lr,
            args.epochs,
            args.iterations_per_epoch,
            args.lr_decay_type,
            args.lr_step_schedule,
            use_warmup=getattr(args, "use_warmup", True),
        )
        self.freeze_feature_extractor = getattr(args, "freeze_feature_extractor", False)
        self.setup_dataloader()
        self.setup_other()
        self.setup_model()
        self.setup_optimizer()

    @property
    def model_name(self) -> str:
        return "Model"

    @property
    def solver_name(self) -> str:
        return type(self).__name__

    @property
    def full_name(self) -> str:
        return self.solver_name + "_" + self.model_name

    @property
    def iterations_per_epoch(self) -> int:
        return self.args.iterations_per_epoch

    @abc.abstractmethod
    def setup_dataloader(self): ...

    def setup_other(self):
        pass

    @abc.abstractmethod
    def setup_model(self): ...

    @abc.abstractmethod
    def setup_optimizer(self): ...

    def end(self):
        pass

    @property
    def global_step(self) -> int:
        return self.iteration // max(self.args.batch_size, 1)

    def adjust_learning_rate(self) -> float:
        """The schedule's rate at the global step, for the log (the step
        writes it into the optimizer itself)."""
        lr = float(self.lr_schedule(self.global_step))
        if self.train_logger is not None:
            self.train_logger.scalar_summary(f"metrics/{self.full_name}/epoch", self.epoch, self.iteration)
            self.train_logger.scalar_summary(f"metrics/{self.full_name}/lr", lr, self.iteration)
        print("Epoch", self.epoch, "Learning rate", lr)
        return lr

    def loss_keys(self):
        return []

    def metric_keys(self):
        return []

    def reset_epoch(self):
        self.logger_iteration = 0
        # the iteration's phases: host wait for the staged batch, the step
        # (ended by the metrics' copy to the host), meters, log and save;
        # total is the wall time
        for key in TIME_KEYS:
            self.time_meters[key] = RollingAverageMeter(self.args.log_frequency)
        for key in self.metric_keys():
            self.metric_meters[key] = RollingAverageMeter(self.args.log_frequency)
        keys = list(self.loss_keys())
        for key in keys:
            self.loss_meters[key] = RollingAverageMeter(self.args.log_frequency)
        if len(keys) > 1:
            self.loss_meters["total_loss"] = RollingAverageMeter(self.args.log_frequency)
        self.adjust_learning_rate()
        # the pretraining encoder's weights (an end-task state has no ``model``:
        # JAX logs nothing for it either)
        model = getattr(getattr(self, "state", None), "model", None)
        if self.train_logger is not None and model is not None:
            self.train_logger.network_weight_summary(
                model, self.iteration, prefix=f"weights/{self.full_name}",
            )

    @abc.abstractmethod
    def run_train_iteration(self): ...

    def run_n_train_iterations(self, num_iterations: int):
        self.reset_epoch()
        for _ in range(num_iterations):
            self.run_train_iteration()

    @abc.abstractmethod
    def run_val(self): ...

    def run_eval(self):
        raise NotImplementedError

    def save(self, num_to_keep: int = -1):
        raise NotImplementedError

    def log_step_metrics(self, metrics: Dict[str, float]):
        """Update the meters from one step's metrics (host floats) and log
        them every ``log_frequency`` iterations."""
        updated_losses, updated_metrics = set(), set()
        total = 0.0
        for key, val in metrics.items():
            val = float(val)
            if key.startswith("loss/"):
                name = key[len("loss/"):]
                if name != "total_loss":
                    total += val
                self.loss_meters.setdefault(name, RollingAverageMeter(self.args.log_frequency)).update(val)
                updated_losses.add(name)
            else:
                self.metric_meters.setdefault(key, RollingAverageMeter(self.args.log_frequency)).update(val)
                updated_metrics.add(key)
        if "total_loss" in self.loss_meters and "total_loss" not in updated_losses:
            self.loss_meters["total_loss"].update(total)
            updated_losses.add("total_loss")
        if not np.isfinite(total):
            raise FloatingPointError(f"non-finite loss at iteration {self.iteration}: {metrics}")

        if self.logger_iteration % self.args.log_frequency == 0 and self.train_logger is not None:
            log = {f"times/{self.full_name}/{k}": m.value for k, m in self.time_meters.items()}
            log.update({f"losses/{self.full_name}/{k}": self.loss_meters[k].value for k in updated_losses})
            log.update({f"metrics/{self.full_name}/{k}": self.metric_meters[k].value for k in updated_metrics})
            self.train_logger.dict_log(log, self.iteration)
