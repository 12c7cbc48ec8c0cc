"""``padding_share`` (%): the share of the engine's prompt steps' rows that
are padding, 1 - real prompt tokens / ``ServeEngine.stats["prefill_tokens"]``
over the traced batch.  Layer: the serving engine (``serving/engine.py``),
which right-aligns a batch's prompts to its longest and prefills the
padding as tokens."""


def read(obs):
    fed = obs.stats.get("prefill_tokens", 0)
    if fed <= 0:
        return None
    return 100.0 * (1.0 - sum(obs.prompt_lens) / fed)
