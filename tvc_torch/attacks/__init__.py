"""Attack suite (port of ``tvc/attacks``): six image attacks against CLIP
and the text attack, differentiated through ``torch.autograd`` over the
einsum module. The adaptive attacker is not ported yet."""

from tvc_torch.attacks.common import (  # noqa: F401
    AttackResult,
    AttackStats,
    TARGETED_SUCCESS_SIM,
    UNTARGETED_SUCCESS_SIM,
    l2_project,
    linf_project,
    make_encoder,
)
from tvc_torch.attacks.cw import (  # noqa: F401
    CWAttackConfig,
    CWAttackPresets,
    CWAttacker,
    create_cw_attacker,
)
from tvc_torch.attacks.fgsm import (  # noqa: F401
    FGSMAttackConfig,
    FGSMAttackPresets,
    FGSMAttacker,
    create_fgsm_attacker,
)
from tvc_torch.attacks.fsta import (  # noqa: F401
    FSTAAttackConfig,
    FSTAAttackPresets,
    FSTAAttacker,
    create_fsta_attacker,
)
from tvc_torch.attacks.hubness import (  # noqa: F401
    HubnessAttack,
    HubnessAttackConfig,
    HubnessAttackPresets,
    HubnessAttacker,
    create_hubness_attacker,
    hubness_score,
)
from tvc_torch.attacks.pgd import (  # noqa: F401
    PGDAttackConfig,
    PGDAttackPresets,
    PGDAttacker,
    create_pgd_attacker,
)
from tvc_torch.attacks.sma import (  # noqa: F401
    SMAAttackConfig,
    SMAAttackPresets,
    SMAAttacker,
    create_sma_attacker,
    jpeg_approx,
)
from tvc_torch.attacks.text_attack import (  # noqa: F401
    BUILTIN_SYNONYMS,
    STOPWORDS,
    TextAttackConfig,
    TextAttacker,
    TextAttackResult,
    create_text_attacker,
    get_synonyms,
)
