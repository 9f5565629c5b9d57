from .priors import (  # noqa: F401
    Prior,
    PriorSet,
    CITY_PERSONS_9_PRIORS,
    ECP_9_PRIORS,
    ECP_NIGHT_9_PRIORS,
    ECP_DAY_NIGHT_9_PRIORS,
    ECP_BIC_9_PRIORS,
    PRIOR_SETS,
)
from .blueprint import (  # noqa: F401
    Variant,
    VariantSpec,
    DetScaleBlueprint,
    ModelBlueprint,
    STRIDES,
)
