"""Framework-wide constants (own copy of `xfmr_rec_tpu/params.py`'s
serving subset; the values must stay identical so one artifact serves
from either package)."""

# data column names (MovieLens-1M schema)
ITEM_IDX_COL = "movie_rn"
ITEM_ID_COL = "movie_id"
ITEM_TEXT_COL = "movie_text"
USER_IDX_COL = "user_rn"
USER_ID_COL = "user_id"
USER_TEXT_COL = "user_text"

TOP_K = 20

# serving artifact layout
MODEL_NAME = "xfmr_rec_tpu"
INDEX_DIR = "index"
PROCESSORS_JSON = "processors.json"
PORTABLE_NPZ = "encoder.npz"
PORTABLE_JSON = "portable.json"
VOCAB_JSON = "vocab.json"
