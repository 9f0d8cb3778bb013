"""DB export CLI (port of ``pyabc_tpu/storage/export.py``).

``python -m pyabc_tpu_torch.storage.export --db abc.db --out out.csv``
dumps the stored populations to csv/json/html/feather/hdf (format by
extension).  It needs ``click`` and ``pandas``; nothing else of the port
imports it.
"""

from __future__ import annotations

import click
import pandas as pd

from .history import History


def history_to_df(history: History, m: int = None) -> pd.DataFrame:
    frames = []
    for t in range(history.max_t + 1):
        models = history.alive_models(t) if m is None else [m]
        for mm in models:
            df, w = history.get_distribution(m=mm, t=t)
            if not len(df):
                continue
            df = df.copy()
            df["w"] = w
            df["t"] = t
            df["m"] = mm
            frames.append(df)
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()


def df_to_file(df: pd.DataFrame, path: str):
    """Format by extension (reference storage/df_to_file.py:43-46)."""
    if path.endswith(".csv"):
        df.to_csv(path, index=False)
    elif path.endswith(".json"):
        df.to_json(path)
    elif path.endswith(".html"):
        df.to_html(path, index=False)
    elif path.endswith(".feather"):
        df.to_feather(path)
    elif path.endswith((".h5", ".hdf")):
        df.to_hdf(path, key="pyabc")
    elif path.endswith(".dta"):
        df.to_stata(path)
    else:
        raise ValueError(f"unsupported export extension: {path}")


@click.command("abc-export")
@click.option("--db", required=True, help="sqlite database file")
@click.option("--out", required=True, help="output file (format by ext)")
@click.option("--id", "abc_id", default=1, type=int, help="run id")
@click.option("--model", "m", default=None, type=int, help="model index")
def main(db, out, abc_id, m):
    history = History(db, abc_id=abc_id)
    df = history_to_df(history, m=m)
    df_to_file(df, out)
    click.echo(f"exported {len(df)} rows to {out}")


if __name__ == "__main__":
    main()
