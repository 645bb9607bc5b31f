"""Data requirements passed from stepper to loaders
(reference: fme/ace/requirements.py:8).

A copy of ``ace_tpu/data/requirements.py`` (numpy on the host; tests hold it equal to
the original).
"""

import dataclasses


@dataclasses.dataclass
class DataRequirements:
    names: list[str]
    n_timesteps: int
    # the loader may omit variables absent from the dataset, emitting
    # NaN-filled placeholders plus per-variable presence masks
    # (reference: fme/ace/requirements.py:45); False = missing variables
    # raise
    allow_missing_variables: bool = False


@dataclasses.dataclass
class PrognosticStateDataRequirements:
    """Requirements for the prognostic state of the model
    (reference: fme/ace/requirements.py:24).
    """

    names: list[str]
    n_timesteps: int
