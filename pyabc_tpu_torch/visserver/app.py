"""Single-page UI of the visualization server (``visserver/server.py``;
port of ``pyabc_tpu/visserver/app.py``, the same page).

The server exposes a JSON API and this page renders it with inline-SVG
charts: run/model/parameter selectors, a generation slider with
play-through animation of the posterior, epsilon/acceptance
trajectories and model-probability bars, without page reloads.

When the server is started with ``--run-dir`` a live fleet card appears
on top, polling ``/api/fleet`` every 2 s while the run is in flight:
per-host throughput, wire MB/s, retries/degrades/checkpoints, engine
builds, the engine decision and an eps/acceptance trajectory fed from
the telemetry snapshots (the History learns a generation only at its
append).  The study-trace card reads ``/api/trace/<id>`` (a study's
lifecycle events folded by ``telemetry/studytrace.py``).
"""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>pyabc_tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.5em;max-width:72em}
 h1{font-size:1.3em} h2{font-size:1.05em;margin:.4em 0 .2em}
 .row{display:flex;flex-wrap:wrap;gap:1.5em;align-items:flex-start}
 .card{border:1px solid #ddd;border-radius:8px;padding:.8em 1em}
 select,button,input{font:inherit;margin:0 .4em .4em 0}
 svg{background:#fafafa;border-radius:4px}
 .lbl{fill:#555;font-size:11px} .axis{stroke:#999;stroke-width:1}
 .hover{fill:#c33;font-size:12px}
 table{border-collapse:collapse;font-size:.85em}
 td,th{border:1px solid #ddd;padding:.15em .5em;text-align:right}
</style></head><body>
<h1>pyabc_tpu — ABC-SMC runs</h1>
<div class=card id=livecard style="display:none;margin-bottom:1em">
 <h2>live run <span id=liveinfo class=lbl></span></h2>
 <div class=row>
  <div><div id=livehosts></div></div>
  <svg id=livetraj width=340 height=180></svg>
 </div>
</div>
<div class=card style="margin-bottom:1em">
 <h2>study trace — latency waterfall <span id=traceinfo class=lbl></span></h2>
 <input id=tracekey placeholder="trace id / ticket id / digest" size=44>
 <button id=tracego>assemble</button>
 <div class=row>
  <svg id=waterfall width=560 height=170 style="display:none"></svg>
  <div id=traceevents></div>
 </div>
</div>
<div>
 run <select id=run></select>
 model <select id=model></select>
 parameter <select id=param></select>
 t <input type=range id=tslider min=0 max=0 value=0 style="width:12em">
 <span id=tlabel></span>
 <button id=play>&#9654; play</button>
</div>
<div class=row>
 <div class=card><h2>posterior KDE <span id=kdeinfo class=lbl></span></h2>
  <svg id=kde width=420 height=260></svg></div>
 <div class=card><h2>epsilon / acceptance</h2>
  <svg id=eps width=340 height=260></svg></div>
 <div class=card><h2>model probabilities</h2>
  <svg id=probs width=340 height=260></svg></div>
</div>
<div class=card style="margin-top:1em"><h2>populations</h2>
 <div id=pops></div></div>
<script>
const $=id=>document.getElementById(id);
const S={run:null,model:null,t:0,param:null,meta:null,timer:null};
async function j(u){const r=await fetch(u);if(!r.ok)throw new Error(u);return r.json()}
function opt(sel,vals,fmt){sel.innerHTML='';for(const v of vals){const o=document.createElement('option');o.value=v;o.textContent=fmt?fmt(v):v;sel.appendChild(o)}}
function line(svg,xs,ys,opts={}){
 const W=svg.clientWidth||+svg.getAttribute('width'),H=svg.clientHeight||+svg.getAttribute('height');
 const p=38,q=18;const xmin=Math.min(...xs),xmax=Math.max(...xs);
 let ymin=opts.ymin??Math.min(...ys),ymax=opts.ymax??Math.max(...ys);
 if(ymax===ymin){ymax+=1;ymin-=1}
 const X=x=>p+(x-xmin)/(xmax-xmin||1)*(W-p-q), Y=y=>H-q-(y-ymin)/(ymax-ymin)*(H-q-q-8);
 if(!opts.keep)svg.innerHTML='';
 const ax=`<line class=axis x1=${p} y1=${H-q} x2=${W-q} y2=${H-q}/><line class=axis x1=${p} y1=${H-q} x2=${p} y2=${q}/>`+
  `<text class=lbl x=${p} y=${H-4}>${xmin.toPrecision(3)}</text><text class=lbl x=${W-q-40} y=${H-4}>${xmax.toPrecision(3)}</text>`+
  `<text class=lbl x=2 y=${H-q}>${ymin.toPrecision(3)}</text><text class=lbl x=2 y=${q+8}>${ymax.toPrecision(3)}</text>`;
 const pts=xs.map((x,i)=>`${X(x).toFixed(1)},${Y(ys[i]).toFixed(1)}`).join(' ');
 svg.innerHTML+=(opts.keep?'':ax)+`<polyline points="${pts}" fill="none" stroke="${opts.color||'#1667c0'}" stroke-width="2" opacity="${opts.opacity??1}"/>`+
  (opts.label?`<text class=lbl x=${W-q-70} y=${q+(opts.li||0)*13+10} fill="${opts.color}">${opts.label}</text>`:'');
 return {X,Y};
}
async function loadRuns(){
 const runs=await j('/api/runs');opt($('run'),runs.map(r=>r.id),v=>'run '+v);
 S.run=runs[0]?.id;await loadRun();
}
async function loadRun(){
 S.run=+$('run').value||S.run;
 S.meta=await j('/api/run/'+S.run);
 opt($('model'),S.meta.models);S.model=S.meta.models[0];
 opt($('param'),S.meta.parameters[S.model]||[]);S.param=($('param').value||null);
 $('tslider').max=S.meta.max_t;$('tslider').value=S.meta.max_t;S.t=S.meta.max_t;
 drawStatic();await drawKde();
}
function drawStatic(){
 const P=S.meta.populations.filter(p=>p.t>=0&&p.epsilon!=null);
 line($('eps'),P.map(p=>p.t),P.map(p=>Math.log10(Math.max(p.epsilon,1e-12))),{color:'#1667c0',label:'log10 eps'});
 line($('eps'),P.map(p=>p.t),P.map(p=>p.acceptance_rate),{keep:true,color:'#2a9d3a',label:'acc rate',li:1,ymin:0,ymax:1});
 const probs=S.meta.model_probabilities;const svg=$('probs');svg.innerHTML='';
 const ts=Object.keys(probs).map(Number).sort((a,b)=>a-b);
 const W=340,H=260,p=38,q=18,bw=(W-p-q)/Math.max(ts.length,1);
 const colors=['#1667c0','#e08a1e','#2a9d3a','#c33','#7b52ab'];
 ts.forEach((t,i)=>{let y=H-q;
  for(const m of S.meta.models){const v=probs[t][m]||0;const h=v*(H-q-q);
   svg.innerHTML+=`<rect x=${(p+i*bw).toFixed(1)} y=${(y-h).toFixed(1)} width=${Math.max(bw-2,1).toFixed(1)} height=${h.toFixed(1)} fill="${colors[m%5]}"><title>t=${t} m=${m}: ${v.toFixed(3)}</title></rect>`;y-=h}
  svg.innerHTML+=`<text class=lbl x=${(p+i*bw).toFixed(1)} y=${H-4}>${t}</text>`});
 let html='<table><tr><th>t</th><th>epsilon</th><th>samples</th><th>acc rate</th><th>particles</th></tr>';
 for(const r of S.meta.populations)html+=`<tr><td>${r.t}</td><td>${r.epsilon==null?'&#8734;':r.epsilon.toPrecision(4)}</td><td>${r.samples}</td><td>${r.acceptance_rate.toFixed(4)}</td><td>${r.particles}</td></tr>`;
 $('pops').innerHTML=html+'</table>';
}
async function drawKde(){
 S.model=+$('model').value;S.param=$('param').value;S.t=+$('tslider').value;
 $('tlabel').textContent='t='+S.t;
 if(!S.param){$('kde').innerHTML='';return}
 const d=await j(`/api/kde/${S.run}/${S.model}/${S.t}?x=${encodeURIComponent(S.param)}`);
 line($('kde'),d.grid,d.density,{color:'#1667c0'});
 $('kdeinfo').textContent=`${S.param} | model ${S.model} | ${d.n} particles`;
}
$('run').onchange=loadRun;
$('model').onchange=async()=>{S.model=+$('model').value;opt($('param'),S.meta.parameters[S.model]||[]);await drawKde()};
$('param').onchange=drawKde;$('tslider').oninput=drawKde;
$('play').onclick=()=>{
 if(S.timer){clearInterval(S.timer);S.timer=null;$('play').innerHTML='&#9654; play';return}
 $('tslider').value=0;$('play').innerHTML='&#9632; stop';
 S.timer=setInterval(async()=>{let t=+$('tslider').value;
  if(t>=S.meta.max_t){clearInterval(S.timer);S.timer=null;$('play').innerHTML='&#9654; play';return}
  $('tslider').value=t+1;await drawKde()},600)};
async function pollFleet(){
 let d;try{d=await j('/api/fleet')}catch(e){return}
 if(!d.enabled)return;
 $('livecard').style.display='';
 let live='';const p=d.run_progress;
 if(p&&p.active)live=` | in-dispatch: gen=${p.gen} done=${p.gens_done}/${p.t_limit}`+(p.eps==null?'':` eps=${(+p.eps).toPrecision(4)}`)+` rounds=${p.rounds||0}`;
 $('liveinfo').textContent=`engine=${d.engine||'-'} | ${d.hosts.length} host(s)`+(d.pod_hosts>1?` | pod=${d.pod_hosts}`:'')+live;
 let html='<table><tr><th>host</th><th>state</th><th>shard</th><th>gens</th><th>evals</th><th>acc</th><th>acc_n</th><th>coll s</th><th>d2h MB/s</th><th>compiles</th><th>retries</th><th>degrades</th><th>ckpts</th><th>flights</th></tr>';
 for(const h of d.hosts)html+=`<tr><td>${h.host}:${h.pid}</td><td>${h.alive==null?'?':h.alive?'alive':'STALE'}</td><td>${h.process_index==null?'-':'h'+h.process_index}</td><td>${h.generations}</td><td>${h.evaluations}</td><td>${(+h.acceptance_rate).toFixed(4)}</td><td>${h.accepted||0}</td><td>${(+(h.collective_s||0)).toFixed(2)}</td><td>${(+h.d2h_mb_per_s).toFixed(2)}</td><td>${h.n_compiles}</td><td>${h.retries}</td><td>${h.degrades}</td><td>${h.checkpoints}</td><td>${h.flight_dumps}</td></tr>`;
 $('livehosts').innerHTML=html+'</table>';
 const T=d.trajectory.filter(r=>r.eps!=null);
 if(T.length>1){
  line($('livetraj'),T.map(r=>r.gen),T.map(r=>Math.log10(Math.max(r.eps,1e-12))),{color:'#1667c0',label:'log10 eps'});
  const A=d.trajectory.filter(r=>r.accepted!=null&&r.total);
  if(A.length>1)line($('livetraj'),A.map(r=>r.gen),A.map(r=>r.accepted/r.total),{keep:true,color:'#2a9d3a',label:'acc rate',li:1,ymin:0,ymax:1});
 }
}
// per-study latency waterfall: /api/trace/<id> (trace id, ticket id
// or digest) -> one horizontal bar per critical-path phase, offset by
// the phases before it, so the card reads like a request waterfall
const PHASES=['queue_wait_s','claim_to_dispatch_s','compile_s','device_s','drain_s','publish_s'];
const PCOLORS=['#8899aa','#e08a1e','#c33','#1667c0','#2a9d3a','#7b52ab'];
async function drawTrace(){
 const key=$('tracekey').value.trim();if(!key)return;
 let d;try{d=await j('/api/trace/'+encodeURIComponent(key))}catch(e){$('traceinfo').textContent='error';return}
 if(!d.enabled){$('traceinfo').textContent='needs --run-dir';return}
 if(!d.found){$('traceinfo').textContent='no trace found';$('waterfall').style.display='none';$('traceevents').innerHTML='';return}
 const ph=d.phases||{},total=Math.max(ph.total_s||0,1e-9);
 $('traceinfo').textContent=`${(total*1e3).toFixed(1)}ms | bounces=${ph.bounces||0} | workers=${(d.workers||[]).join(',')||'-'}`;
 const svg=$('waterfall');svg.style.display='';svg.innerHTML='';
 const W=560,H=170,L=140,R=70,bh=16;let off=0;
 PHASES.forEach((p,i)=>{const v=ph[p]||0;const x=L+off/total*(W-L-R),w=Math.max(v/total*(W-L-R),v>0?1:0),y=8+i*(bh+8);
  svg.innerHTML+=`<text class=lbl x=2 y=${y+12}>${p.slice(0,-2)}</text>`+
   `<rect x=${x.toFixed(1)} y=${y} width=${w.toFixed(1)} height=${bh} fill="${PCOLORS[i]}"><title>${p}: ${(v*1e3).toFixed(2)}ms</title></rect>`+
   `<text class=lbl x=${(x+w+4).toFixed(1)} y=${y+12}>${(v*1e3).toFixed(1)}ms</text>`;
  off+=v});
 let html='<table><tr><th>event</th><th>worker</th><th>detail</th></tr>';
 for(const e of d.events||[]){const skip=new Set(['trace_id','event','unix','mono','pid','digest','ticket','worker']);
  const det=Object.keys(e).filter(k=>!skip.has(k)).map(k=>`${k}=${e[k]}`).join(' ');
  html+=`<tr><td>${e.event}</td><td>${e.worker||'-'}</td><td style="text-align:left">${det}</td></tr>`}
 $('traceevents').innerHTML=html+'</table>';
}
$('tracego').onclick=drawTrace;
$('tracekey').onkeydown=e=>{if(e.key==='Enter')drawTrace()};
pollFleet();setInterval(pollFleet,2000);
loadRuns();
</script></body></html>
"""
