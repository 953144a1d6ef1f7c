from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.registry import get_model, register

# Import model modules for their registration side effects.
from yt8m_tpu_torch.models import attention as _attention  # noqa: F401
from yt8m_tpu_torch.models import frame as _frame  # noqa: F401
from yt8m_tpu_torch.models import netvlad as _netvlad  # noqa: F401
from yt8m_tpu_torch.models import netvlad_lstm as _netvlad_lstm  # noqa: F401
from yt8m_tpu_torch.models import nextvlad as _nextvlad  # noqa: F401
from yt8m_tpu_torch.models import rnn as _rnn  # noqa: F401
