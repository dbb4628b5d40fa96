from . import (activation, common, conv, extras, layers, norm, pooling, rnn,
               transformer)
from . import loss as _loss
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .layers import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (layers.__all__ + common.__all__ + activation.__all__
           + conv.__all__ + extras.__all__ + norm.__all__ + pooling.__all__
           + rnn.__all__ + transformer.__all__ + _loss.__all__)
