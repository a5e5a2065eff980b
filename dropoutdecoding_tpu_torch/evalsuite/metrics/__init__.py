from .bleu import bleu_scores
from .cider import CiderScorer
from .rouge import rouge_l
from .meteor import meteor_lite
from .evalcap import CocoCaptionEvaluator
