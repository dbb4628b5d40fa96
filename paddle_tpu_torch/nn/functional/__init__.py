from . import activation as _activation
from . import attention as _attention
from . import common as _common
from . import conv as _conv
from . import extras as _extras
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling
from .activation import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

__all__ = list(dict.fromkeys(
    _attention.__all__ + _common.__all__ + _activation.__all__
    + _norm.__all__ + _conv.__all__ + _pooling.__all__ + _extras.__all__
    + _loss.__all__))
