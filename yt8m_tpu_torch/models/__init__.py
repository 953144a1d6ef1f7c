from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.registry import (
    get_model,
    is_frame_level_model,
    list_models,
    register,
)

# Import model modules for their registration side effects.
from yt8m_tpu_torch.models import video as _video  # noqa: F401
from yt8m_tpu_torch.models import frame as _frame  # noqa: F401
from yt8m_tpu_torch.models import rnn as _rnn  # noqa: F401
from yt8m_tpu_torch.models import netvlad as _netvlad  # noqa: F401
from yt8m_tpu_torch.models import netvlad_lstm as _netvlad_lstm  # noqa: F401
from yt8m_tpu_torch.models import attention as _attention  # noqa: F401
from yt8m_tpu_torch.models import chain as _chain  # noqa: F401
from yt8m_tpu_torch.models import nextvlad as _nextvlad  # noqa: F401
from yt8m_tpu_torch.models import cnn as _cnn  # noqa: F401
from yt8m_tpu_torch.models import netfv as _netfv  # noqa: F401
from yt8m_tpu_torch.models import deep_chain as _deep_chain  # noqa: F401
