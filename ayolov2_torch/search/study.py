"""A small sequential model-based search engine (in the role of Optuna).

The counterpart of ``ayolov2_tpu/search/study.py``, with the same draws: a
study with the same seed and history suggests the same parameters, and it
reads and writes the same JSON storage. The surface the entry points use:

  - ``create_study(direction, storage, study_name, load_if_exists)``
  - ``study.optimize(objective, n_trials)`` where objective(trial) uses
    ``trial.suggest_float / suggest_int / suggest_categorical``
  - JSON-file storage with resume, and a backup of a file that holds
    another study (or of any file when not ``load_if_exists``)

Sampling: the first ``n_startup_trials`` are uniform random, then one
Tree-structured Parzen Estimator step per parameter: the history splits
into the top gamma-quantile (good) and the rest, candidates are drawn from
a Gaussian mixture on the good values, and the one with the best
good/bad density ratio is kept (Bergstra et al., NeurIPS 2011).
"""

from __future__ import annotations

import json
import logging
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

LOGGER = logging.getLogger(__name__)


class Trial:
    """One parameter-suggestion context passed to the objective."""

    def __init__(self, study: "Study", number: int, params: Optional[Dict[str, Any]] = None) -> None:
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        self._fixed = params or {}
        self.user_attrs: Dict[str, Any] = {}

    # -- suggest API ------------------------------------------------------
    def suggest_float(self, name: str, low: float, high: float, step: Optional[float] = None) -> float:
        if name in self._fixed:
            v = float(self._fixed[name])
        else:
            v = self.study._sample(name, low, high, step=step, is_int=False)
        if step:
            v = low + round((v - low) / step) * step
        v = float(min(max(v, low), high))
        self.params[name] = v
        return v

    def suggest_int(self, name: str, low: int, high: int, step: int = 1) -> int:
        if name in self._fixed:
            v = int(self._fixed[name])
        else:
            v = int(round(self.study._sample(name, low, high, step=step, is_int=True)))
        v = low + int(round((v - low) / step)) * step
        v = int(min(max(v, low), high))
        self.params[name] = v
        return v

    def suggest_categorical(self, name: str, choices: List[Any]) -> Any:
        if name in self._fixed:
            v = self._fixed[name]
        else:
            idx = self.study._sample(name + "__cat", 0, len(choices) - 1, step=1, is_int=True)
            v = choices[int(round(idx))]
        self.params[name] = v
        return v

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value


class Study:
    """Maximize/minimize a scalar objective over suggested parameters."""

    def __init__(
        self,
        direction: str = "maximize",
        storage: Optional[Union[str, Path]] = None,
        study_name: str = "study",
        sampler_seed: int = 0,
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        n_ei_candidates: int = 24,
    ) -> None:
        assert direction in ("maximize", "minimize")
        self.direction = direction
        self.study_name = study_name
        self.storage = Path(storage) if storage else None
        self.trials: List[Dict[str, Any]] = []
        self.rng = np.random.default_rng(sampler_seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_ei_candidates = n_ei_candidates
        if self.storage and self.storage.exists():
            self._load()

    # -- persistence ------------------------------------------------------
    def _load(self) -> None:
        try:
            data = json.loads(self.storage.read_text())
            if data.get("study_name") not in (None, self.study_name):
                backup = self.storage.with_suffix(f".backup_{int(time.time())}.json")
                self.storage.rename(backup)
                LOGGER.warning("storage study-name conflict; backed up to %s", backup)
                return
            self.trials = data.get("trials", [])
            LOGGER.info("loaded %d trials from %s", len(self.trials), self.storage)
        except (json.JSONDecodeError, OSError) as e:
            LOGGER.warning("could not load study storage: %s", e)

    def _save(self) -> None:
        if not self.storage:
            return
        self.storage.parent.mkdir(parents=True, exist_ok=True)
        self.storage.write_text(
            json.dumps({"study_name": self.study_name, "direction": self.direction, "trials": self.trials})
        )

    # -- sampling ---------------------------------------------------------
    def _history(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = [], []
        for t in self.trials:
            if t.get("state") == "complete" and name in t["params"]:
                xs.append(float(t["params"][name]))
                ys.append(float(t["value"]))
        return np.asarray(xs), np.asarray(ys)

    def _sample(self, name: str, low: float, high: float, step=None, is_int=False) -> float:
        xs, ys = self._history(name)
        if len(xs) < self.n_startup_trials:
            return float(self.rng.uniform(low, high))
        # TPE: split into good (top gamma) / bad
        order = np.argsort(ys)
        if self.direction == "maximize":
            order = order[::-1]
        n_good = max(1, int(math.ceil(self.gamma * len(xs))))
        good, bad = xs[order[:n_good]], xs[order[n_good:]]
        if len(bad) == 0:
            bad = xs
        width = max((high - low) / 10.0, 1e-9)

        def log_density(v: np.ndarray, centers: np.ndarray) -> np.ndarray:
            d = (v[:, None] - centers[None, :]) / width
            return np.log(np.mean(np.exp(-0.5 * d * d) + 1e-12, axis=1))

        cand = self.rng.choice(good, size=self.n_ei_candidates) + self.rng.normal(
            0.0, width, self.n_ei_candidates
        )
        cand = np.clip(cand, low, high)
        score = log_density(cand, good) - log_density(cand, bad)
        return float(cand[int(np.argmax(score))])

    # -- driving ----------------------------------------------------------
    def ask(self, fixed_params: Optional[Dict[str, Any]] = None) -> Trial:
        return Trial(self, number=len(self.trials), params=fixed_params)

    def tell(self, trial: Trial, value: Optional[float], state: str = "complete") -> None:
        self.trials.append(
            {
                "number": trial.number,
                "params": trial.params,
                "value": None if value is None else float(value),
                "state": state,
                "user_attrs": trial.user_attrs,
            }
        )
        self._save()

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int = 100,
        catch: Tuple = (),
    ) -> None:
        for _ in range(n_trials):
            trial = self.ask()
            try:
                value = objective(trial)
            except catch as e:  # noqa: PERF203 (optuna's catch)
                LOGGER.warning("trial %d failed: %s", trial.number, e)
                self.tell(trial, None, state="fail")
                continue
            self.tell(trial, value)
            best = self.best_trial
            LOGGER.info(
                "trial %d: value %.5f params %s (best %.5f)",
                trial.number, value, trial.params, best["value"],
            )

    # -- results ----------------------------------------------------------
    @property
    def completed(self) -> List[Dict[str, Any]]:
        return [t for t in self.trials if t.get("state") == "complete"]

    @property
    def best_trial(self) -> Dict[str, Any]:
        done = self.completed
        assert done, "no completed trials"
        key = (lambda t: t["value"]) if self.direction == "minimize" else (lambda t: -t["value"])
        return min(done, key=key)

    @property
    def best_params(self) -> Dict[str, Any]:
        return self.best_trial["params"]

    @property
    def best_value(self) -> float:
        return self.best_trial["value"]


def create_study(
    direction: str = "maximize",
    storage: Optional[Union[str, Path]] = None,
    study_name: str = "study",
    load_if_exists: bool = True,
    **kwargs,
) -> Study:
    """Optuna-shaped constructor."""
    if not load_if_exists and storage and Path(storage).exists():
        backup = Path(storage).with_suffix(f".backup_{int(time.time())}.json")
        Path(storage).rename(backup)
        LOGGER.info("existing storage backed up to %s", backup)
    return Study(direction=direction, storage=storage, study_name=study_name, **kwargs)
