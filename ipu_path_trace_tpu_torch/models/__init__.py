from .envlight import ConstantEnv, NifEnv, TextureEnv, bake_nif_env, eval_env
from .nif import NifMetaData, NifModel, NifWeights, load_nif_assets, make_params, nif_apply
from .quant import QuantNifModel, quantize_nif
