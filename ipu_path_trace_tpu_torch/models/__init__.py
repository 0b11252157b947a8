from .envlight import ConstantEnv, NifEnv, eval_env
from .nif import NifMetaData, NifModel, NifWeights, load_nif_assets, make_params, nif_apply
