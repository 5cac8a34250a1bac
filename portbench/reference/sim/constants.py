"""Physical and RL constants (the port's own copy of ble_tpu/utils/constants.py;
values from the reference utils/constants.py:21-38).

Units: SI floats; absolute time is int32 unix seconds (UTC).
"""

GRAVITY: float = 9.80665  # [m/s^2]
NUM_SECONDS_PER_HOUR: int = 3_600
NUM_SECONDS_PER_DAY: int = 86_400
UNIVERSAL_GAS_CONSTANT: float = 8.3144621  # [J/(mol.K)]
DRY_AIR_MOLAR_MASS: float = 0.028964922481160  # [kg/mol]
HE_MOLAR_MASS: float = 0.004002602  # [kg/mol]
DRY_AIR_SPECIFIC_GAS_CONSTANT: float = (
    UNIVERSAL_GAS_CONSTANT / DRY_AIR_MOLAR_MASS)  # [J/(kg.K)]

AGENT_TIME_STEP_SECONDS: int = 180  # 3 minutes between agent actions.
PERCIATELLI_PRESSURE_RANGE_MIN: float = 5000.0  # [Pa]
PERCIATELLI_PRESSURE_RANGE_MAX: float = 14000.0  # [Pa]

# Inner physics integration stride (reference env/balloon/balloon.py:269).
PHYSICS_STRIDE_SECONDS: int = 10

METERS_PER_FOOT: float = 0.3048
WATT_HOURS_TO_JOULES: float = 3600.0
